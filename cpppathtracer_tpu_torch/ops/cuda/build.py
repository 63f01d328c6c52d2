"""Build and load the port's CUDA kernels.

The sources in ``cpppathtracer_tpu_torch/csrc`` are compiled with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded
with ``ctypes``.  Each ``.cu`` file is compiled by its own ``nvcc``
process, all started together, and then linked.  The build runs at first
use, into ``cpppathtracer_tpu_torch/_build/<hash of sources and flags>``,
so a changed source never loads a stale library.

The kernels are built with ``--fmad=false`` and without fast math: the
plain PyTorch versions never contract a*b+c, and a contracted t flips
closest-hit winners on tangent rays, so the kernels are held against the
plain versions at float32 rounding.

Each wrapper counts its launches in :data:`LAUNCHES`, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# launches per wrapper since the last reset_launches(); mega_trace's with_aux
# form (a kernel instantiation of its own) counts apart
LAUNCHES = {"mega_trace": 0, "mega_trace_aux": 0, "stream_compact": 0, "stream_expand": 0,
            "mega_bwd": 0, "winner_index": 0, "bvh_winner_index": 0, "denoise": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has none yet; return its
    path.  The compiler's register and shared-memory report is kept in
    ``ptxas.log`` beside it."""
    out = build_dir()
    lib = out / "libpoca_kernels.so"
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / (p.stem + ".o") for p in cus]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cus, objs)
        ]
        logs = []
        for src, p in zip(cus, procs):
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (Path(tmp) / "ptxas.log").write_text("\n".join(logs))
        # another process may have finished the same build meanwhile
        try:
            os.rename(tmp, out)
        except OSError:
            if not lib.exists():
                raise
        else:
            os.mkdir(tmp)  # TemporaryDirectory removes it on exit
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int

# argument types of each C entry point (csrc/*.cu, extern "C")
_SIGNATURES = {
    # o3 d3 thru3 pix samp | geom ts trt | n_alive amask | out_f out_o hits aux counter
    # stats | seed word | R n_s n_p n_c n_rep n_pad depth start_bounce | stream
    "poca_mega_trace": [_P] * 11 + [_P] * 3 + [_P] * 2 + [_P] * 6 + [_P] + [_I] * 8 + [_P],
    # aux R n_rep n_pad | info (registers, local bytes, blocks per SM, grid)
    "poca_mega_info": [_I] * 4 + [_P],
    # device | the opt-in shared memory per block
    "poca_smem_optin": [_I, _P],
    # missed planes(ptr array) n_planes out stride offs n_alive status R | stream
    "poca_stream_compact": [_P, _P, _I, _P, _I, _P, _P, _P, _I, _P],
    # missed offs packed(ptr array) n_planes fills(int array) out stride R | stream
    "poca_stream_expand": [_P, _P, _P, _I, _P, _P, _I, _I, _P],
    "poca_compact_block_lanes": [],
    # o3 d3 pix samp ts trt hits | 13 cotangent planes ct_aux | out_tab out_od carry |
    # seed word | R n_pad depth smem_acc | stream
    "poca_mega_bwd": [_P] * 11 + [_P] * 14 + [_P] * 3 + [_P] + [_I] * 4 + [_P],
    # n_pad smem_acc aux | info (registers, local bytes, blocks per SM)
    "poca_mega_bwd_info": [_I] * 3 + [_P],
    # o3 d3 tmin tmax geom | out | R n_s n_p n_c n_rep tile_rows | stream
    "poca_winner_index": [_P] * 9 + [_P] + [_I] * 6 + [_P],
    # R n_rep tile_rows | info (registers, local bytes, blocks per SM, grid)
    "poca_winner_info": [_I] * 3 + [_P],
    # o3 d3 tmin tmax nodes leaves rows gidx | out | R m n_leaves | stream
    "poca_bvh_winner_index": [_P] * 12 + [_P] + [_I] * 3 + [_P],
    # m n_leaves | info (registers, local bytes, blocks per SM, nodes in shared memory)
    "poca_bvh_info": [_I] * 2 + [_P],
    # rad nrm dep out | H W stepwidth | stream
    "poca_denoise": [_P] * 4 + [_I] * 3 + [_P],
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype, shape, device):
    """Validate a kernel argument: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
