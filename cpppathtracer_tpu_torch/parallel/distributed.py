"""Multi-process rendering: initialisation, frame collection and recovery
(counterpart of ``cpppathtracer_tpu/parallel/distributed.py``).

  * every process calls :func:`initialize` (the rendezvous address from
    the arguments or POCA_COORDINATOR, the world size and rank from the
    arguments or POCA_NUM_PROCESSES / POCA_PROCESS_ID); the backend is
    NCCL for CUDA devices and gloo for the CPU, chosen by the device;
  * each process renders the rows :func:`host_tile_rows` gives its rank,
    over a mesh of its own devices (``parallel/render.py``);
  * :func:`gather_frame` assembles the full frame on rank 0;
  * :func:`render_with_recovery` turns failures into checkpoint-resume
    loops (``utils/checkpoint.py``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from cpppathtracer_tpu_torch.types import resolve_device
from cpppathtracer_tpu_torch.utils import checkpoint
from cpppathtracer_tpu_torch.utils.obs import get_logger


def world() -> tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Bring up torch.distributed; nothing happens when a group is already
    up or when neither an address nor a world size is given (a single
    process).  The address is a ``tcp://host:port`` or ``file://path``
    rendezvous (a bare host:port means tcp).  `device` (default: the CUDA
    card) picks the backend: NCCL for CUDA, gloo for the CPU."""
    if dist.is_available() and dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("POCA_COORDINATOR")
    env_n, env_id = os.environ.get("POCA_NUM_PROCESSES"), os.environ.get("POCA_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_n) if env_n else None)
    process_id = process_id if process_id is not None else (int(env_id) if env_id else None)
    if addr is None and num_processes is None:
        return  # single-process run
    if addr is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the address, the world size and the rank")
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=addr if "://" in addr else f"tcp://{addr}",
                            world_size=num_processes, rank=process_id)
    get_logger().info("distributed up (%s): process %d/%d", backend, process_id, num_processes)


def shutdown() -> None:
    """Tear the process group down, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_tile_rows(height: int, n_hosts: int, host: int) -> tuple[int, int]:
    """Row range [lo, hi) a host owns under row-major ty sharding."""
    rows = -(-height // n_hosts)
    lo = min(host * rows, height)
    hi = min(lo + rows, height)
    return lo, hi


def process_rows(height: int) -> tuple[int, int]:
    """The rows this process renders: its rank's :func:`host_tile_rows`.
    A process left without rows (more processes than the band size allows)
    raises."""
    n, rank = world()
    lo, hi = host_tile_rows(height, n, rank)
    if lo == hi:
        raise ValueError(f"{n} processes leave rank {rank} no row of an image {height} rows high")
    return lo, hi


def gather_frame(local_rows) -> np.ndarray | None:
    """Assemble the full frame from each process's band of rows
    (:func:`process_rows`, a tensor [h_rank, ...]) as numpy on rank 0;
    other ranks return None.  With a process group up (of any size), bands
    are padded to the largest, gathered with ``all_gather`` (on the band's
    device: CUDA for NCCL, the CPU for gloo) and cropped; without one the
    band is the frame."""
    band = local_rows.detach().contiguous()
    if not (dist.is_available() and dist.is_initialized()):
        return band.cpu().numpy()
    n, rank = world()
    sizes = [torch.zeros(1, dtype=torch.int64, device=band.device) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([band.shape[0]], dtype=torch.int64, device=band.device))
    sizes = [int(s) for s in sizes]
    padded = band.new_zeros((max(sizes), *band.shape[1:]))
    padded[:band.shape[0]] = band
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded)
    if rank != 0:
        return None
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).cpu().numpy()


def render_with_recovery(step_fn, state, *, checkpoint_path: str,
                         checkpoint_every: int = 32, max_retries: int = 3,
                         metadata=None):
    """Run an iterative render/train loop with checkpoint-based recovery.

    `step_fn(state, i) -> state` is one accumulation step; state is a tree
    (``utils/checkpoint.py``).  On a failure the loop restores the last
    checkpoint and retries, or, before the first checkpoint, the state it
    was entered with.  Tensors are mutable, so that entry state is a deep
    clone taken on entry (and cloned again for each retry): a step that
    changed its state in place before failing cannot leak into the retry.
    """
    log = get_logger()
    i = 0
    if os.path.exists(checkpoint_path):
        state, meta = checkpoint.restore(checkpoint_path, state)
        i = int(meta.get("step", 0))
        log.info("resumed from %s at step %d", checkpoint_path, i)
    initial_state, initial_i = checkpoint.clone(state), i
    retries = 0
    while True:
        try:
            state = step_fn(state, i)
            i += 1
            if i % checkpoint_every == 0:
                checkpoint.save(
                    checkpoint_path, state,
                    {**(metadata or {}), "step": i, "t": time.time()},
                )
            retries = 0
            yield i, state
        except StopIteration:
            return
        except Exception as e:  # noqa: BLE001 — surface-then-retry by design
            retries += 1
            log.error("step %d failed (%s); retry %d/%d", i, e, retries, max_retries)
            if retries > max_retries:
                raise
            if os.path.exists(checkpoint_path):
                state, meta = checkpoint.restore(checkpoint_path, state)
                i = int(meta.get("step", i))
            else:
                state, i = checkpoint.clone(initial_state), initial_i
