"""CUDA graphs of the compiled calls: the port's counterpart of ``jax.jit``.

The JAX package compiles each call a user makes (``integrator.py:515-517``
``render_radiance_jit``, ``renderer.py:98-108`` ``frame_step``,
``inverse.py:75-80`` ``train_step``, ``bench.py:53``'s
``jax.jit(jax.value_and_grad(loss_fn))``) into one XLA program.  Eager
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
- Capture runs each body once on a side stream first (the kernels' build
  and load, ``cudaFuncSetAttribute``, allocator growth), then captures all
  of an entry's bodies into one memory pool, on the device that holds the
  bodies' tensors, which need not be the current one; a replay runs there.
- A kernel wrapper counts its launches in Python, which a replay does not
  run: each :class:`Graph` records how far ``build.LAUNCHES`` moved while
  it was captured, undoes that (nothing was launched), and adds it back at
  every replay.
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
import os

import torch

from cpppathtracer_tpu_torch.ops.cuda import build as kb


def signature(obj):
    """A hashable description of what a capture bakes in about `obj`: a
    tensor's shape, dtype and device; a dataclass's type and fields; the
    items of a tuple or list; any other value itself."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, signature(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(signature(x) for x in obj)
    if isinstance(obj, dict):
        return tuple((k, signature(v)) for k, v in obj.items())
    return obj


def map_tensors(obj, fn):
    """`obj` with `fn` applied to every tensor in it (through dataclasses,
    tuples and dicts)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_tensors(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(map_tensors(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    return obj


def tensors(obj):
    """The tensors of `obj` (through dataclasses, tuples and dicts), in
    order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))
    elif isinstance(obj, tuple):
        for x in obj:
            yield from tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from tensors(x)


def static_twin(obj):
    """`obj` with every tensor in it replaced by a detached clone: the
    buffers a captured body reads."""
    return map_tensors(obj, lambda t: t.detach().clone())


def copy_into(static, current):
    """Copy every tensor of `current` into its place in `static` (the same
    structure, as :func:`signature` says); a tensor that is its own static
    buffer is left alone."""
    with torch.no_grad():  # a buffer takes values, never an autograd history
        for dst, src in zip(tensors(static), tensors(current), strict=True):
            if dst is not src:
                dst.copy_(src)


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
        before = dict(kb.LAUNCHES)
        try:
            self._graph = backend.capture(body, pool, device)
        finally:
            after = dict(kb.LAUNCHES)
            kb.LAUNCHES.update(before)  # capturing launched nothing
        self.launches = {k: n - before[k] for k, n in after.items() if n != before[k]}

    def replay(self):
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
    as attributes by the code that builds it."""


class GraphedCall:
    """A bounded cache of captured entries, keyed by what they bake in.

    ``entry(key, build)`` returns the entry of `key`, or makes one with
    ``build(self)``, which sets up its static buffers and calls
    :meth:`capture` with its bodies; past `max_entries` the least recently
    used entry is released.  `captures` counts the bodies captured so far."""

    def __init__(self, max_entries: int = 4, backend=None):
        self.max_entries = max_entries
        self.backend = backend if backend is not None else CudaGraphs()
        self.captures = 0
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._building: list | None = None

    def entry(self, key, build):
        if key in self._entries:
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
