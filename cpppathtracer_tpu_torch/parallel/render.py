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

With a ``torch.distributed`` group of more than one process, each process
renders the band of rows that :func:`~cpppathtracer_tpu_torch.parallel.
distributed.host_tile_rows` gives its rank, over its own mesh, and
``distributed.gather_frame`` assembles the frame on rank 0.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
import torch.distributed as dist

from cpppathtracer_tpu_torch.integrator import render_graphed, render_radiance
from cpppathtracer_tpu_torch.parallel.distributed import process_rows, world
from cpppathtracer_tpu_torch.parallel.mesh import TileMesh, pad_to_tiles
from cpppathtracer_tpu_torch.utils.graphs import GraphedCall

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
    """`obj` (a tensor, or a dataclass or tuple holding tensors, such as a
    Scene or a Camera) with its tensors on `device`; through autograd, so
    gradients flow back to the original."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(to_device(x, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device) for f in dataclasses.fields(obj)
        })
    return obj


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
        reps = {dev: (to_device(scene, dev), to_device(camera, dev), to_device(sky_tex, dev),
                      to_device(seed, dev))
                for dev in mesh.distinct_devices()}
        outs = [_tile_render(*reps[dev][:3], grid[ys, xs].to(dev), spp, max_depth, reps[dev][3],
                             runner)
                for dev, ys, xs in _tile_slices(mesh, grid)]
        h, w = rows[1] - rows[0], camera.width
        return tuple(_assemble(mesh, [o[k] for o in outs])[:h, :w] for k in range(3))


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
    """

    def loss_fn(params, scene, camera, sky_tex, pix, target):
        out = mesh.first_device
        reps = {}
        for dev in mesh.distinct_devices():
            p = {k: v.to(dev) for k, v in params.items()}
            reps[dev] = (to_device(scene, dev).with_material_params(p),
                         to_device(camera, dev), to_device(sky_tex, dev))
        sums, counts = [], []
        for dev, ys, xs in _tile_slices(mesh, pix):
            pix_t = pix[ys, xs].to(dev)
            rad, _, _ = _tile_render(*reps[dev], pix_t, spp, max_depth, seed)
            valid = (pix_t >= 0).to(torch.float32)[..., None]
            err = (rad - target[ys, xs].to(dev)) * valid
            sums.append(torch.sum(err * err).to(out))
            counts.append((torch.sum(valid) * 3.0).to(out))
        total, n = torch.stack(sums).sum(), torch.stack(counts).sum()
        if world()[0] > 1:
            dist.all_reduce(n)
        return total / n

    return loss_fn
