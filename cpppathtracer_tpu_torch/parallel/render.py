"""The pixel-tile render and the sharded inverse-rendering loss (counterpart
of ``cpppathtracer_tpu/parallel/render.py``).

One process drives every device of its mesh, as ``shard_map``'s single
controller does: the scene, camera and sky are copied once to each device,
every tile's render is queued before any result is collected (so several
cards overlap), and the frame is assembled on the mesh's first device.
On the card each tile's render is compiled, as JAX jits it
(``parallel/render.py:68``): a replay of the render graph of its device and
tile shape (``integrator.render_graphed`` on :func:`tile_graphs`, the
mesh's own cache), whose buffers take the tile's global pixel indices, the
camera and the seed, so every frame, seed and tile of one shape on one
device replays one capture; on the CPU it is ``render_radiance(pixel_idx=
tile)``.  The RNG is keyed by *global* pixel ids and
padded entries render pixel 0 and are cropped, so the tiled frame equals
the unsharded one bitwise wherever each tile takes the frame's survivor
split (``ops/mega.py::_split_plan``, which follows the ray count: a
1024^2 frame and its 512^2 tiles both split, at depth 3 or less nothing
does).  A tile that takes another plan adds the same radiance terms in
another float32 order, as a device of the JAX package's mesh does.

The sharded loss (:func:`make_sharded_loss`) is eager; its value and
gradients are compiled on the card as JAX jits them
(:func:`make_sharded_value_and_grad`, the counterpart of
``jax.jit(jax.value_and_grad(loss))``): one graph of every tile's forward
and backward for each distinct device of the mesh, and two small ones on
the first device, the count of valid values before them and the sums
after, with the copies across devices issued by the host between the
replays (:func:`capture_sharded_grad`).  ``inverse.
make_sharded_train_step`` adds the optimizer's update to the same entry.

With a ``torch.distributed`` group of more than one process, each process
renders the band of rows that :func:`~cpppathtracer_tpu_torch.parallel.
distributed.host_tile_rows` gives its rank, over its own mesh, and
``distributed.gather_frame`` assembles the frame on rank 0.
"""

from __future__ import annotations

import functools
import weakref

import torch
import torch.distributed as dist

from cpppathtracer_tpu_torch.integrator import render_graphed, render_radiance
from cpppathtracer_tpu_torch.parallel.distributed import process_rows, world
from cpppathtracer_tpu_torch.parallel.mesh import TileMesh, pad_to_tiles
from cpppathtracer_tpu_torch.utils import obs
from cpppathtracer_tpu_torch.utils.graphs import (
    Entry,
    GraphedCall,
    copy_into,
    env_switches,
    map_tensors,
    signature,
    static_twin,
)

# each mesh's tile graphs, kept while the mesh lives
_TILE_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def tile_graphs(mesh: TileMesh, backend=None) -> GraphedCall:
    """The cache of `mesh`'s tile graphs, made on first use with `backend`
    (default the card's).  Its entries are keyed as
    ``integrator.render_key`` keys them, so by each tile's device and
    shape; it holds as many as the mesh has tiles, so the keys of one
    frame never evict each other.  ``tile_graphs(mesh).clear()`` frees
    them."""
    graphs = _TILE_GRAPHS.get(mesh)
    if graphs is None:
        graphs = _TILE_GRAPHS[mesh] = GraphedCall(max_entries=len(mesh.tiles()), backend=backend)
    return graphs


def to_device(obj, device):
    """`obj` (a tensor, or a structure holding tensors, such as a Scene or
    a Camera) with its tensors on `device`; through autograd, so gradients
    flow back to the original."""
    return map_tensors(obj, lambda t: t.to(device))


def _tile_render(scene, camera, sky_tex, pixel_idx_tile, spp, max_depth, seed, runner=None):
    """Render one tile.  pixel_idx_tile: i32[th, tw] of GLOBAL flat pixel
    indices, -1 for padding (rendered as pixel 0).  With `runner`, a
    replay of its render graph for this tile's device and shape (the
    outputs are copies, never the graph's buffers); else eagerly."""
    th, tw = pixel_idx_tile.shape
    render = render_radiance if runner is None else functools.partial(render_graphed, runner)
    rad, n0, t0 = render(
        scene, camera, sky_tex, spp=spp, max_depth=max_depth, seed=seed,
        pixel_idx=pixel_idx_tile.reshape(-1).clamp(min=0),
    )
    return rad.reshape(th, tw, 3), n0.reshape(th, tw, 3), t0.reshape(th, tw)


def global_pixel_grid(camera, mesh: TileMesh, rows: tuple[int, int] | None = None):
    """Global flat pixel indices i32[Hp, Wp] of image rows [lo, hi) (all
    rows by default), padded to the mesh tiling with -1, on the mesh's
    first device."""
    h, w = camera.height, camera.width
    lo, hi = (0, h) if rows is None else rows
    hp, wp = pad_to_tiles(hi - lo, w, mesh)
    dev = mesh.first_device
    y = torch.arange(lo, lo + hp, device=dev)[:, None]
    x = torch.arange(wp, device=dev)[None, :]
    idx = (y * w + x).to(torch.int32)
    return torch.where((y < hi) & (x < w), idx, torch.full_like(idx, -1))


def _tile_slices(mesh: TileMesh, grid):
    """(device, row slice, column slice) of each tile of a padded grid."""
    ty, tx = mesh.shape
    th, tw = grid.shape[0] // ty, grid.shape[1] // tx
    return [(dev, slice(i * th, (i + 1) * th), slice(j * tw, (j + 1) * tw))
            for i, j, dev in mesh.tiles()]


def _assemble(mesh: TileMesh, tiles):
    """The [ty, tx] tiles (row-major list) joined into one tensor on the
    mesh's first device."""
    ty, tx = mesh.shape
    out = mesh.first_device
    return torch.cat([
        torch.cat([tiles[i * tx + j].to(out) for j in range(tx)], dim=1) for i in range(ty)
    ], dim=0)


def render_image_sharded(scene, camera, sky_tex, mesh: TileMesh, *, spp, max_depth, seed=0):
    """Tiled render of this process's rows [lo, hi)
    (``distributed.process_rows``: the whole image in a single process) ->
    (radiance f32[h, W, 3], normal f32[h, W, 3], depth f32[h, W]) on the
    mesh's first device, h = hi - lo.  On the card each tile replays the
    graph of its device and shape in :func:`tile_graphs`; `seed` is an
    int or an i32 0-dim tensor on the mesh's first device."""
    runner = tile_graphs(mesh) if mesh.first_device.type == "cuda" else None
    return render_tiles(runner, scene, camera, sky_tex, mesh, spp=spp, max_depth=max_depth,
                        seed=seed)


def render_tiles(runner, scene, camera, sky_tex, mesh: TileMesh, *, spp, max_depth, seed=0):
    """:func:`render_image_sharded`'s body: each tile through the graphs of
    `runner` (its capture backend decides what a capture is), or eagerly
    with `runner` None."""
    rows = process_rows(camera.height)
    grid = global_pixel_grid(camera, mesh, rows)
    with torch.no_grad():  # serving
        reps = {dev: to_device((scene, camera, sky_tex, seed), dev)
                for dev in mesh.distinct_devices()}
        outs = [_tile_render(*reps[dev][:3], grid[ys, xs].to(dev), spp, max_depth, reps[dev][3],
                             runner)
                for dev, ys, xs in _tile_slices(mesh, grid)]
        h, w = rows[1] - rows[0], camera.width
        return tuple(_assemble(mesh, [o[k] for o in outs])[:h, :w] for k in range(3))


def _valid(pix_tile):
    return (pix_tile >= 0).to(torch.float32)[..., None]


def _tile_sq_err(scene, camera, sky_tex, pix_tile, target_tile, spp, max_depth, seed):
    """One tile's masked squared error, summed (0-dim)."""
    rad, _, _ = _tile_render(scene, camera, sky_tex, pix_tile, spp, max_depth, seed)
    err = (rad - target_tile) * _valid(pix_tile)
    return torch.sum(err * err)


def _tile_count(pix_tile):
    """The count of one tile's valid values (three a pixel), a float."""
    return torch.sum(_valid(pix_tile)) * 3.0


def make_sharded_loss(mesh: TileMesh, spp: int, max_depth: int, seed: int = 0):
    """Build loss(params, scene, camera, sky_tex, pix, target) for sharded
    inverse rendering.

    `params` is a dict of material fields (a subset of
    ``Scene.material_params()``); `pix` is the grid of
    :func:`global_pixel_grid` and `target` the f32[Hp, Wp, 3] goal image
    padded the same way.  Each tile's masked squared error is summed and
    divided by the global count of valid values.  Each device takes the
    parameters by ``.to()`` inside autograd, so the backward sums the
    tiles' gradients (the counterpart of shard_map's psum).  With a
    ``torch.distributed`` group of more than one process the count is
    all-reduced and the loss returned is this process's share of it: the
    shares, and their gradients, sum over the ranks to the loss and its
    gradient (``inverse.make_sharded_train_step`` all-reduces both).
    This is the eager form: :func:`make_sharded_value_and_grad` gives its
    value and gradients compiled.
    """

    def loss_fn(params, scene, camera, sky_tex, pix, target):
        out = mesh.first_device
        reps = {}
        for dev in mesh.distinct_devices():
            scene_d, camera_d, sky_d, p = to_device((scene, camera, sky_tex, params), dev)
            reps[dev] = (scene_d.with_material_params(p), camera_d, sky_d)
        sums, counts = [], []
        for dev, ys, xs in _tile_slices(mesh, pix):
            pix_t = pix[ys, xs].to(dev)
            sums.append(_tile_sq_err(*reps[dev], pix_t, target[ys, xs].to(dev), spp, max_depth,
                                     seed).to(out))
            counts.append(_tile_count(pix_t).to(out))
        total, n = torch.stack(sums).sum(), torch.stack(counts).sum()
        if world()[0] > 1:
            dist.all_reduce(n)
        return total / n

    return loss_fn


def make_sharded_value_and_grad(mesh: TileMesh, spp: int, max_depth: int, seed: int = 0, *,
                                eager: bool = False):
    """The value and parameter gradients of :func:`make_sharded_loss`, the
    counterpart of ``jax.jit(jax.value_and_grad(make_sharded_loss(...)))``
    (``scripts/bench_scaling.py:112-113``).

    Returns vg(params, scene, camera, sky_tex, pix, target) -> (loss,
    {field: gradient}), the loss's arguments; with a ``torch.distributed``
    group of more than one process, this process's share of both, as the
    loss gives it.  On the card vg is compiled (:func:`sharded_grad_graphed`
    on the graphs ``vg.graphs``, which ``.clear()`` frees): the same loss
    bit for bit, the same gradients as far as the backward's float atomics
    repeat.  On the CPU, and with `eager`, it is the eager loss and
    ``torch.autograd.grad``, one PyTorch operation at a time."""
    loss_fn = make_sharded_loss(mesh, spp, max_depth, seed)
    graphs = GraphedCall(max_entries=2)

    def value_and_grad(params, scene, camera, sky_tex, pix, target):
        if eager or scene.device.type == "cpu":
            loss = loss_fn(params, scene, camera, sky_tex, pix, target)
            grads = torch.autograd.grad(loss, list(params.values()))
            return loss.detach(), dict(zip(params, grads))
        return sharded_grad_graphed(graphs, mesh, spp, max_depth, seed, params, scene, camera,
                                    sky_tex, pix, target)

    value_and_grad.graphs = graphs
    return value_and_grad


def sharded_grad_key(mesh: TileMesh, spp, max_depth, seed, params, inputs):
    """The cache key of the compiled sharded value and gradients: the mesh,
    the render settings, the shape, dtype and device of every input
    (`inputs` = (scene, camera, sky_tex, pix, target)) and the POCA_*
    switches that choose the route."""
    layout = (mesh.shape, tuple(str(d) for d in mesh.devices.flat))
    return ("sharded_grad", layout, spp, max_depth, seed, signature((params, inputs)),
            env_switches())


def sharded_grad_graphed(runner: GraphedCall, mesh: TileMesh, spp, max_depth, seed, params,
                         scene, camera, sky_tex, pix, target):
    """The compiled sharded value and gradients on the graphs of `runner`
    (its capture backend decides what a capture is): (loss, {field:
    gradient}), copies of the graphs' buffers on the mesh's first
    device."""
    inputs = (scene, camera, sky_tex, pix, target)
    e = runner.entry(lambda: sharded_grad_key(mesh, spp, max_depth, seed, params, inputs),
                     lambda r: capture_sharded_grad(r, mesh, spp, max_depth, seed, params, inputs))
    replay_sharded_grad(e, params, inputs)
    return e.loss.clone(), {k: g.clone() for k, g in e.grads.items()}


def capture_sharded_grad(runner: GraphedCall, mesh: TileMesh, spp, max_depth, seed, params,
                         inputs):
    """The entry of one key of the compiled sharded value and gradients,
    its graphs replayed in this order by :func:`replay_sharded_grad`:

    - `count`, on the mesh's first device: n, the count of valid values of
      the static pixel grid, tile by tile, stacked and summed as the loss
      does (it depends on the grid alone);
    - `bodies`, one for each distinct device of the mesh: that device's
      static copy of the parameters, leaves that require grad, and its
      twins of scene, camera and sky; every tile the device holds
      rendered and its masked squared error summed; ``torch.autograd.
      grad`` of those sums onto the parameters, each sum's cotangent the
      1 / n that autograd of total / n hands it; the sums and the
      gradients written into one flat static buffer on the device;
    - `reduce`, on the first device: the tiles' sums stacked in tile order
      and summed, over n (`loss`), and each field's gradient summed over
      the devices in mesh order (`grads`).

    A capture is bound to one device's stream, so what crosses devices
    (the caller's values in, n out, each device's flat buffer back to the
    first device) is copied by the host between replays; each copy orders
    the two devices' streams itself, and no host waits.  Warm-up and
    capture run on the static buffers alone."""
    scene, camera, sky_tex, pix, target = inputs
    first = mesh.first_device
    e = Entry()
    e.first, e.devices = first, mesh.distinct_devices()
    e.tiles = _tile_slices(mesh, pix)
    e.pix, e.target = pix.detach().to(first).clone(), target.detach().to(first).clone()
    # each tile's pixels and target: views of the full grids on the first device (as the
    # loss reads them there), static copies on the others
    e.tile_in = [(e.pix[ys, xs], e.target[ys, xs]) if dev == first
                 else (e.pix[ys, xs].to(dev), e.target[ys, xs].to(dev)) for dev, ys, xs in e.tiles]
    e.n = torch.zeros((), device=first)
    e.params, e.inputs, e.n_on, e.flat, e.landed, e.mine = {}, {}, {}, {}, {}, {}
    n_grads = sum(v.numel() for v in params.values())
    for d in e.devices:
        e.mine[d] = [i for i, (dev, _, _) in enumerate(e.tiles) if dev == d]
        e.params[d] = {k: v.detach().to(d).clone().requires_grad_(True)
                       for k, v in params.items()}
        e.inputs[d] = static_twin(to_device((scene, camera, sky_tex), d))
        e.n_on[d] = e.n if d == first else torch.zeros((), device=d)
        e.flat[d] = torch.zeros(len(e.mine[d]) + n_grads, device=d)
        e.landed[d] = e.flat[d] if d == first else torch.zeros_like(e.flat[d], device=first)
    # (device, place in its flat buffer) of each tile's sum, in tile order
    where = [(d, e.mine[d].index(i)) for i, (d, _, _) in enumerate(e.tiles)]

    def count():
        e.n.copy_(torch.stack([_tile_count(e.pix[ys, xs]) for _, ys, xs in e.tiles]).sum())

    def device_body(d):
        def body():
            sc, cam, sky = e.inputs[d]
            sc = sc.with_material_params(e.params[d])
            sums = [_tile_sq_err(sc, cam, sky, *e.tile_in[i], spp, max_depth, seed)
                    for i in e.mine[d]]
            ct = torch.ones((), device=d) / e.n_on[d]
            grads = torch.autograd.grad(sums, list(e.params[d].values()),
                                        grad_outputs=[ct] * len(sums))
            with torch.no_grad():
                torch.cat([torch.stack(sums), *(g.reshape(-1) for g in grads)], out=e.flat[d])

        return body

    def reduce():
        e.loss = torch.stack([e.landed[d][pos] for d, pos in where]).sum() / e.n
        e.grads, start = {}, 0
        for k, v in params.items():
            parts = [e.landed[d][len(e.mine[d]) + start:][:v.numel()] for d in e.devices]
            g = parts[0].clone()
            for x in parts[1:]:
                g += x
            e.grads[k] = g.view(v.shape)
            start += v.numel()

    (e.count,) = runner.capture(count, device=first)
    for d in e.devices:  # the bodies' warm-up and capture divide by the grid's own count
        if d != first:
            e.n_on[d].copy_(e.n)
    e.bodies = {d: runner.capture(device_body(d), device=d)[0] for d in e.devices}
    (e.reduce,) = runner.capture(reduce, device=first)
    return e


def replay_sharded_grad(e: Entry, params, inputs):
    """Copy the caller's values into the buffers of a
    :func:`capture_sharded_grad` entry and replay its graphs: `e.loss` and
    `e.grads` then hold the loss and the gradients (this process's share
    in a group of several) until the entry's next replay.  All the copies
    into the devices go ahead of the devices' bodies: a copy from the
    first device runs on its stream, which would otherwise hold it behind
    the first device's own body, and the devices would take turns.  The
    copies across devices and the all-reduce of n are ``mesh.exchange``
    spans (`bytes`), the reduce's replay a ``mesh.reduce`` span."""
    scene, camera, sky_tex, pix, target = inputs
    with obs.span("graphs.copy_in") as sp:
        copy_into((e.pix, e.target), (pix, target), sp)
        for d in e.devices:
            copy_into((e.params[d], e.inputs[d]), (params, (scene, camera, sky_tex)), sp)
    e.count.replay()
    with obs.span("mesh.exchange") as sp:
        if world()[0] > 1:
            dist.all_reduce(e.n)
        for d in e.devices:
            if d != e.first:
                e.n_on[d].copy_(e.n)
                sp.count("bytes", e.n.nbytes)
        for (dev, ys, xs), (pix_t, target_t) in zip(e.tiles, e.tile_in):
            if dev != e.first:
                pix_t.copy_(e.pix[ys, xs])
                target_t.copy_(e.target[ys, xs])
                sp.count("bytes", pix_t.nbytes + target_t.nbytes)
    for d in e.devices:
        e.bodies[d].replay()
    with obs.span("mesh.exchange") as sp:
        for d in e.devices:
            if d != e.first:
                e.landed[d].copy_(e.flat[d])
                sp.count("bytes", e.flat[d].nbytes)
    with obs.span("mesh.reduce"):
        e.reduce.replay()
