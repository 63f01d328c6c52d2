"""CUDA graphs of the compiled calls: the port's counterpart of ``jax.jit``.

The JAX package compiles each call a user makes (``integrator.py:515-517``
``render_radiance_jit``, ``renderer.py:98-108`` ``frame_step``,
``inverse.py:75-80`` ``train_step`` and ``:118`` its sharded twin,
``bench.py:53``'s ``jax.jit(jax.value_and_grad(loss_fn))``) into one XLA
program.  Eager
PyTorch issues the same work one operation at a time, and on the card the
host then sets the pace.  A :class:`GraphedCall`
captures a call's bodies once with ``torch.cuda.graph`` and replays them.

Its design:

- The bodies read *static* buffers: clones of the caller's scene, camera,
  sky and textures (:func:`static_twin`), a sample-key buffer and the
  like.  Before each replay the caller's current tensors are copied into
  them (:func:`copy_into`), so a moved camera, an edited material or a
  refitted scene replays the same graph.  What the bodies bake in is the
  cache key: the shapes and dtypes of every input (:func:`signature`) and
  the static arguments (resolution, samples, depth, seed, the route and
  the environment switches the route reads, :func:`env_switches`).
  Every one of these walks a call's inputs by one rule (:func:`_walk`):
  into dataclasses, tuples and dicts.  A dataclass field declared a plain
  value (``Scene.type_perm``, say) is taken whole: its value goes into the
  key as it is, and no copy looks inside it, so no call walks a large
  tuple element by element.
- Capture runs each body once on a side stream first (the kernels' build
  and load, ``cudaFuncSetAttribute``, allocator growth), then captures the
  bodies of one :meth:`GraphedCall.capture` call into one memory pool, on
  the device that holds the bodies' tensors, which need not be the
  current one; a replay runs there.  An entry whose work spans devices
  (the sharded training step, ``parallel/render.py``) makes one call for
  each device, and its caller copies what crosses devices between the
  replays: a capture records one device's stream.
- A kernel wrapper counts its launches in Python, which a replay does not
  run: each :class:`Graph` records how far ``build.LAUNCHES`` moved while
  it was captured, undoes that (nothing was launched), and adds it back at
  every replay.
- The host's work around a replay is traced by spans (``utils/obs.py``,
  recorded while a ``torch.profiler`` profile runs): ``graphs.entry``
  (the key and the lookup, `hit` 0 or 1),
  ``graphs.capture`` (warm-up and capture, `bodies`), ``graphs.copy_in``
  (the copies into the buffers and the writes beside them, `tensors` and
  `bytes`, opened by the caller)
  and ``graphs.replay`` (`card`).  No span lies inside a body.
- A capture that fails raises.  Nothing falls back to the eager bodies:
  a caller that wants eager work calls the eager function
  (``integrator.render_radiance``, ``renderer.frame_step``,
  ``inverse.make_train_step(..., eager=True)``, ``bench.train_step``).
- A body may change state, as the training step's does (an Adam update,
  ``inverse.py``): its parameters and optimizer state are static buffers
  too, the caller's values copied in before each replay and the updated
  values copied back into the caller's tensors after it.  Warm-up and
  capture run the body on the buffers alone, so they change nothing the
  caller holds: the first replay takes the first step.

The capture itself is a backend (:class:`CudaGraphs` on the card), so the
bookkeeping can be tested on the CPU with a stand-in that runs the body.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os

import torch

from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.utils import obs


@functools.cache
def dataclass_fields(cls) -> tuple:
    """The fields of dataclass type `cls`, made once a type: each field's
    name with True where it is declared a plain value
    (``dataclasses.field(..., metadata={"static": True})``), in declaration
    order."""
    return tuple((f.name, bool(f.metadata.get("static"))) for f in dataclasses.fields(cls))


def _walk(obj, leaf, node):
    """The compiled calls' one walk of a structure: `leaf(t)` of every
    tensor, and `node(obj, kids)` of every dataclass, tuple and dict, where
    `kids` holds its items walked (a tuple's as a tuple, a dict's and a
    dataclass's as a dict by key or field name).  A dataclass field
    declared a plain value is taken whole: its value itself, unwalked (a
    tuple of 16,384 ints costs one step, not 16,384), and TypeError if it
    holds a tensor, which no walk would copy nor put in a key.  Anything
    else (a list, None, a number) is a leaf that stands for itself."""
    if isinstance(obj, torch.Tensor):
        return leaf(obj)
    if isinstance(obj, tuple):
        return node(obj, tuple([_walk(x, leaf, node) for x in obj]))
    if isinstance(obj, dict):
        return node(obj, {k: _walk(v, leaf, node) for k, v in obj.items()})
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kids = {}
        for name, whole in dataclass_fields(type(obj)):
            value = getattr(obj, name)
            if isinstance(value, torch.Tensor):
                if whole:
                    raise TypeError(f"{type(obj).__name__}.{name} is declared a plain value "
                                    "(static), which the compiled calls take whole, but holds "
                                    "a tensor")
                value = leaf(value)
            elif not whole:
                value = _walk(value, leaf, node)
            kids[name] = value
        return node(obj, kids)
    return obj


def _signature_node(obj, kids):
    if isinstance(obj, tuple):
        return kids
    items = tuple(kids.items())
    return items if isinstance(obj, dict) else (type(obj).__name__,) + items


def signature(obj):
    """A hashable description of what a capture bakes in about `obj`: a
    tensor's shape, dtype and device; a dataclass's type and fields (a
    field declared a plain value as its value itself); the items of a
    tuple or dict; any other value itself."""
    return _walk(obj, lambda t: ("tensor", tuple(t.shape), t.dtype, t.device), _signature_node)


def _rebuild(obj, kids):
    return kids if isinstance(obj, (tuple, dict)) else dataclasses.replace(obj, **kids)


def map_tensors(obj, fn):
    """`obj` with `fn` applied to every tensor in it (a dataclass field
    declared a plain value passes unchanged)."""
    return _walk(obj, fn, _rebuild)


def tensors(obj) -> list:
    """The tensors of `obj` (not in a field declared a plain value), in
    order."""
    found = []
    _walk(obj, found.append, lambda obj, kids: None)
    return found


def static_twin(obj):
    """`obj` with every tensor in it replaced by a detached clone: the
    buffers a captured body reads."""
    return map_tensors(obj, lambda t: t.detach().clone())


def copy_into(static, current, span=obs.OFF):
    """Copy every tensor of `current` into its place in `static` (the same
    structure, as :func:`signature` says); a tensor that is its own static
    buffer is left alone.  `span`, an open ``graphs.copy_in`` span, counts
    the tensors copied and their bytes."""
    counting = span.on
    pairs = list(zip(tensors(static), tensors(current), strict=True))
    with torch.no_grad():  # a buffer takes values, never an autograd history
        for dst, src in pairs:
            if dst is not src:
                dst.copy_(src)
                if counting:
                    span.count("tensors")
                    span.count("bytes", dst.nbytes)


def requires_grad(*objs) -> bool:
    return any(t.requires_grad for obj in objs for t in tensors(obj))


def env_switches() -> tuple:
    """The POCA_* environment switches: the route a render takes reads
    them, so a capture bakes them in."""
    return tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith("POCA_")))


class CudaGraphs:
    """The card's capture backend: warm-up on a side stream, then
    ``torch.cuda.graph`` into a shared pool, each on the device that holds
    the bodies' tensors (the kernel wrappers launch on that device's
    current stream, so a capture on another device would record nothing)."""

    def pool(self):
        return torch.cuda.graph_pool_handle()

    def warmup(self, bodies, device):
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for body in bodies:
                    body()
            torch.cuda.current_stream(device).wait_stream(side)

    def capture(self, body, pool, device):
        """The captured graph (``replay()``, ``reset()``); raises
        RuntimeError when the body cannot be captured."""
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    graph, pool=pool, stream=torch.cuda.Stream(device)):
                body()
        except Exception as e:
            # torch.cuda.graph leaves its capture stream current when ending
            # the capture raises: later work would run there, unordered with
            # the default stream
            torch.cuda.set_stream(current)
            raise RuntimeError(f"CUDA graph capture failed (nothing ran eagerly instead): {e}") from e
        return _OnDevice(graph, device)


class _OnDevice:
    """A ``torch.cuda.CUDAGraph`` replayed and reset on its own device."""

    def __init__(self, graph, device):
        self.graph, self.device = graph, device

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()

    def reset(self):
        with torch.cuda.device(self.device):
            self.graph.reset()


class Graph:
    """One captured body.  :meth:`replay` runs it and adds the launches
    that its capture counted to ``build.LAUNCHES``.

    The graph keeps its body, and so every tensor the body's closure
    holds: a replay reads the addresses the capture saw, and a buffer
    made outside the capture that nothing else kept (an index vector, say)
    would otherwise go back to the allocator and be handed to other
    tensors while the graph still reads it."""

    def __init__(self, backend, body, pool, device):
        self._body = body
        self.card = torch.device(device).index or 0
        before = dict(kb.LAUNCHES)
        try:
            self._graph = backend.capture(body, pool, device)
        finally:
            after = dict(kb.LAUNCHES)
            kb.LAUNCHES.update(before)  # capturing launched nothing
        self.launches = {k: n - before[k] for k, n in after.items() if n != before[k]}

    def replay(self):
        with obs.span("graphs.replay", card=self.card):
            self._graph.replay()
        for k, n in self.launches.items():
            kb.LAUNCHES[k] += n

    def release(self):
        """Free the graph.  Its body goes too, which breaks the cycle of an
        entry whose bodies close over it, so the entry's buffers are freed
        as soon as the cache drops it."""
        self._graph.reset()
        self._graph = self._body = None


class Entry:
    """The state of one cached entry: its static buffers and graphs, set
    as attributes by the code that builds it.  Its graphs may lie on
    several devices, from one :meth:`GraphedCall.capture` call each."""


class GraphedCall:
    """A bounded cache of captured entries, keyed by what they bake in.

    ``entry(key, build)`` returns the entry of the key ``key()`` gives, or
    makes one with ``build(self)``, which sets up its static buffers and
    calls :meth:`capture` with its bodies; past `max_entries` the least
    recently used entry is released.  `captures` counts the bodies
    captured so far."""

    def __init__(self, max_entries: int = 4, backend=None):
        self.max_entries = max_entries
        self.backend = backend if backend is not None else CudaGraphs()
        self.captures = 0
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._building: list | None = None

    def entry(self, key, build):
        with obs.span("graphs.entry") as sp:
            key = key()  # part of every call's host time
            hit = key in self._entries
            sp.count("hit", int(hit))
            if hit:
                self._entries.move_to_end(key)
                return self._entries[key][0]
            self._building = []
            try:
                made = build(self)
            except BaseException:
                self._release(self._building)
                raise
            finally:
                graphs, self._building = self._building, None
            self._entries[key] = (made, graphs)
            while len(self._entries) > self.max_entries:
                self._release(self._entries.popitem(last=False)[1][1])
            return made

    def capture(self, *bodies, device):
        """Warm each body up, then capture each, in order, into one pool,
        all on `device` (the device of the tensors the bodies work on): a
        list of :class:`Graph`.  A later body may read the tensors an
        earlier one made, provided every replay runs them in this order."""
        with obs.span("graphs.capture", bodies=len(bodies)):
            self.backend.warmup(bodies, device)
            pool = self.backend.pool()
            graphs = [Graph(self.backend, body, pool, device) for body in bodies]
        self.captures += len(graphs)
        if self._building is not None:
            self._building.extend(graphs)
        return graphs

    def keys(self):
        return list(self._entries)

    def __getitem__(self, key):
        return self._entries[key][0]

    def clear(self):
        """Release every entry's graphs and their memory."""
        while self._entries:
            self._release(self._entries.popitem()[1][1])

    @staticmethod
    def _release(graphs):
        for g in graphs:
            g.release()
