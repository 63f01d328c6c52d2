"""What each design step of the megakernel (#1) and the dense winner kernel
(#2-#4) buys, on one NVIDIA card.

    python3 scripts/torch_kernel_steps.py [--reps 3] [--sass PARENT_CSRC] [--out FILE]

(`--reps 0 --sass PARENT_CSRC`: the SASS counts alone.)

The kernels' design steps, and the edit of the package's sources in
``cpppathtracer_tpu_torch/csrc`` that turns each off (:data:`STEP_EDITS`):

  early_exit  a path ends at its first miss (#1; off: every lane runs
              every bounce)
  warp_skip   a warp skips per-object work no lane needs (winner.cuh;
              off: the vote is always true)
  row16       rows read with two 16-byte shared loads (winner.cuh; off:
              eight 4-byte loads)

For each variant (all steps off; each step alone; all on, the package's
sources as they are; all on but one) the script copies the sources into a
temporary directory, makes the edits of the steps that are off there and
builds ``mega_trace.cu`` and ``winner.cu`` into a library of their own,
all builds started together, with the package's nvcc flags.  The
package's wrappers launch each variant in turn (the script points their
library at it).  It times every variant in turns (the order
reversed on every other round) by CUDA events at the main path's shapes:
``mega_trace`` phase A + B of one 1024^2 x d8 sample of demo_scene(0) with
the bench camera, in both forms, and ``winner_index`` on the 1024^2
primaries of big_scene(4096).  Every variant's outputs must equal the
package's bitwise.  Beside them, with the package's kernels, the same
sample traced unsplit (one launch of depth 8 over every lane, which the
early exit makes do the same searches as phase A + B).  It prints each
variant's registers (ptxas), its median times and the card's name and
power limit, and keeps them as JSON with `--out`.

With `--sass`, it also counts the SASS instructions of each innermost
loop of ``winner.cu``'s kernel (``cuobjdump -sass`` of the kernel built as
the package builds it): the search loops over the spheres, the platforms
and the cylinders, one object an iteration unless the compiler unrolled
one (its MUFU count, one square root a sphere, one reciprocal a platform,
three a cylinder, says how often), with the instructions inside the
blocks a warp vote lets a warp skip; for this checkout and for the
sources in PARENT_CSRC (the parent's search, which has no votes).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# step -> (source file, the package's text, the text with the step off)
STEP_EDITS = {
    "early_exit": ("mega_trace.cu",
                   "const bool stop = !hit && (tmin != 0.0f || best_t > POCA_TMIN_BOUNCE);",
                   "const bool stop = false;"),
    "warp_skip": ("winner.cuh",
                  "  return __any_sync(0xffffffffu, pred);",
                  "  return true;"),
    "row16": ("winner.cuh",
              "  return {rows[2 * j], rows[2 * j + 1]};",
              "  const float* g = reinterpret_cast<const float*>(rows) + 8 * j;\n"
              "  return {make_float4(g[0], g[1], g[2], g[3]), make_float4(g[4], g[5], g[6], g[7])};"),
}
STEPS = tuple(STEP_EDITS)
UNITS = ("mega_trace.cu", "winner.cu")
# the C entry points of UNITS
ENTRIES = ("poca_mega_trace", "poca_mega_info", "poca_smem_optin", "poca_winner_index",
           "poca_winner_info")
W = H = 1024
DEPTH = 8
CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))


def variants():
    """name -> the switches that are off"""
    out = {"all_off": STEPS}
    out.update({f"only_{s}": tuple(x for x in STEPS if x != s) for s in STEPS})
    out["package"] = ()
    out.update({f"no_{s}": (s,) for s in STEPS})
    return out


def build_variant(off, root):
    """Build UNITS from a copy of the package's sources under `root` with
    the steps in `off` turned off; returns (library path, ptxas report)."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    csrc = Path(root) / "csrc"
    shutil.copytree(kb.CSRC, csrc)
    for step in off:
        name, old, new = STEP_EDITS[step]
        text = (csrc / name).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"step {step}: its text is not in {name} exactly once")
        (csrc / name).write_text(text.replace(old, new))
    nvcc = kb._nvcc()
    objs = [Path(root) / (Path(u).stem + ".o") for u in UNITS]
    procs = [subprocess.Popen([nvcc, *kb.NVCC_FLAGS, "-I", str(csrc), "-c", str(csrc / u),
                               "-o", str(o)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for u, o in zip(UNITS, objs)]
    report = ""
    for u, proc in zip(UNITS, procs):
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {u} (off: {off}):\n{text}")
        report += text
    lib = Path(root) / "libsteps.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return lib, report


def load(lib_path):
    """The variant's library, its C entry points typed as the package types
    them."""
    import ctypes

    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = kb._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def registers(text):
    """{kernel entry: registers} from a ptxas report"""
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(dev):
    """The main path's inputs: (phase A args and kwargs, phase B's) of one
    demo sample, and the big_scene(4096) primaries with their rows."""
    import torch

    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import stream_compact
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
    from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace
    from cpppathtracer_tpu_torch.ops.fast import group_scene
    from cpppathtracer_tpu_torch.types import INF

    r = W * H
    gs = group_scene(demo_scene(0).build(device=dev))
    camera = Camera.make(W, H, device=dev, **CAMERA)
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    samp = torch.full((r,), 5, dtype=torch.int32, device=dev)
    o, d = camera.ray_gen_planar(pix, samp, 0)
    geom = build_geom_rows(gs)
    ts, trt = build_tables_T(gs)
    args_a = (tuple(c.contiguous() for c in o), tuple(c.contiguous() for c in d), pix, samp, 0,
              geom, ts, trt)
    kw_a = dict(counts=gs.counts, depth=2, with_o=True)
    out_a = mega_trace(*args_a, **kw_a)
    packed, _, n_alive = stream_compact(out_a[3], [pix, samp, *out_a[8], *out_a[1], *out_a[2],
                                                   out_a[3]])
    args_b = (tuple(packed[2:5]), tuple(packed[5:8]), packed[0], packed[1], 0, geom, ts, trt)
    kw_b = dict(counts=gs.counts, depth=DEPTH - 2, start_bounce=2, thru=tuple(packed[8:11]),
                n_alive=n_alive, alive_mask=packed[11])
    gs4 = group_scene(big_scene(4096, bvh=False, device=dev))
    cam4 = big_camera(4096, W, H, device=dev)
    o4, d4 = cam4.ray_gen_planar(pix, torch.zeros_like(pix), 0)
    ray4 = (tuple(c.contiguous() for c in o4), tuple(c.contiguous() for c in d4),
            torch.zeros(r, device=dev), torch.full((r,), INF, device=dev))
    return (args_a, kw_a), (args_b, kw_b), (gs4.counts, *ray4, build_geom_rows(gs4))


@contextlib.contextmanager
def launching(lib):
    """The package's wrappers launch `lib`'s kernels inside the block."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    package = kb.library
    kb.library = lambda: lib
    try:
        yield
    finally:
        kb.library = package


def run_all(libs, reps):
    """Each variant's outputs and times, in turns."""
    import torch

    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import winner_index
    from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import mega_trace

    dev = torch.device("cuda")
    (args_a, kw_a), (args_b, kw_b), win = inputs(dev)

    def sample(aux):
        return (mega_trace(*args_a, **kw_a, with_aux=aux), mega_trace(*args_b, **kw_b, with_aux=aux))

    def planes(outs):
        flat = []
        for out in outs:
            flat += [*out[0], *out[1], *out[2], out[3], *out[4], out[5], *out[6]]
            flat += [c for pos, att in out[7] or () for c in (*pos, att)]
            flat += list(out[8]) if len(out) > 8 else []
        return [p.view(torch.int32) for p in flat]

    results = {name: {"mega_trace": [], "mega_trace_aux": [], "winner_index": []} for name in libs}
    ref = (planes(sample(False)) + planes(sample(True)), winner_index(*win))  # kb.library()'s
    for name, lib in libs.items():
        with launching(lib):
            got = (planes(sample(False)) + planes(sample(True)), winner_index(*win))
        if not (all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
                and torch.equal(got[1], ref[1])):
            raise SystemExit(f"variant {name} differs from the package's kernels")
    print(f"[check] all {len(libs)} variants bitwise equal to the package's kernels", flush=True)
    for rnd in range(reps):
        for name in (list(libs) if rnd % 2 == 0 else list(reversed(libs))):
            r = results[name]
            with launching(libs[name]):
                r["mega_trace"].append(time_ms(lambda: sample(False), 10))
                r["mega_trace_aux"].append(time_ms(lambda: sample(True), 10))
                r["winner_index"].append(time_ms(lambda: winner_index(*win), 5))
                if name == "package":
                    r.setdefault("mega_trace_unsplit", []).append(
                        time_ms(lambda: mega_trace(*args_a, **dict(kw_a, depth=DEPTH)), 10))
            print(f"[round {rnd + 1}] {name}: " + ", ".join(
                f"{k} {v[-1]:.4f} ms" for k, v in r.items()), flush=True)
    return results


# ------------------------------------------------------------------ SASS

def _parse_sass(text):
    """{function: [(address, opcode, predicated, branch target or None)]}
    from ``cuobjdump -sass`` (or ``nvdisasm``) text, NOPs left out."""
    funcs, name, labels = {}, None, {}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if not (m and name):
            continue
        addr, op = int(m.group(1), 16), m.group(3)
        for lab, at in labels.items():
            if at is None:
                labels[lab] = addr
        target = None
        if op.startswith("BRA"):
            t = re.search(r"`\((\.L_x_\d+)\)|0x([0-9a-f]+)", m.group(4))
            if t:
                target = t.group(1) or int(t.group(2), 16)
        if op != "NOP":
            funcs[name].append((addr, op.split(".")[0], bool(m.group(2)), target))
    resolve = lambda t: labels.get(t) if isinstance(t, str) else t
    return {f: [(a, o, p, resolve(t)) for a, o, p, t in body] for f, body in funcs.items()}


def inner_loops(body):
    """The innermost loops of a function: for each backward branch that
    encloses no other, its instructions' opcode counts, its size, and the
    instructions inside the blocks a warp vote guards (from the first
    predicated forward branch after each VOTE to the branch's target),
    block by block in address order."""
    back = [(t, a) for a, o, _, t in body if o == "BRA" and t is not None and t < a]
    inner = [(t, a) for t, a in back
             if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a for t2, a2 in back)]
    loops = []
    for t, a in sorted(inner):
        ins = [x for x in body if t <= x[0] <= a]
        ops = {}
        for _, o, _, _ in ins:
            ops[o] = ops.get(o, 0) + 1
        blocks = []
        for k, (_, o, _, _) in enumerate(ins):
            if o in ("VOTE", "VOTEU"):
                jump = next((x for x in ins[k + 1:] if x[1] == "BRA" and x[2] and x[3] and x[3] > x[0]),
                            None)
                if jump:
                    blocks.append(sum(1 for x in ins if jump[0] < x[0] < jump[3]))
        loops.append(dict(instructions=len(ins), voted_blocks=blocks,
                          when_skipped=len(ins) - sum(blocks), by_opcode=dict(sorted(ops.items()))))
    return loops


def sass_loops(csrc):
    """The innermost loops of csrc/winner.cu's kernel (its search loops
    over the spheres, platforms and cylinders, in that order, and its
    staging loop), built as the package builds it."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    nvcc = kb._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "winner.cubin"
        flags = [f for f in kb.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([nvcc, *flags, "-cubin", "-I", str(csrc), "-o", str(cubin),
                        str(Path(csrc) / "winner.cu")], check=True, capture_output=True, text=True)
        text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                              text=True).stdout
    (body,) = [b for f, b in _parse_sass(text).items() if "winner_index_kernel" in f]
    return inner_loops(body)


def time_variants(reps, report):
    """Build every variant, check it against the package's kernels and time
    them all in turns; their registers and times go into `report`."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    t0 = time.perf_counter()
    kb.library()  # the package's full library: the inputs use its compaction
    var = variants()
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(var)) as pool:
        built = dict(zip(var, pool.map(lambda kv: build_variant(kv[1], Path(tmp) / kv[0]),
                                       var.items())))
        print(f"[build] {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        libs = {name: load(path) for name, (path, _) in built.items()}
    report["registers"] = {name: registers(text) for name, (_, text) in built.items()}
    for name, regs in report["registers"].items():
        print(f"[ptxas] {name} (off: {', '.join(var[name]) or 'none'}): {regs}", flush=True)
    results = run_all(libs, reps)
    report["ms"] = {name: {k: statistics.median(v) for k, v in r.items()} for name, r in results.items()}
    report["runs"] = results
    for name, r in report["ms"].items():
        print(f"[median] {name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in r.items()), flush=True)
    print(json.dumps(report["ms"]), flush=True)



def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", metavar="PARENT_CSRC")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_steps: no CUDA device; nothing was run")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    report = {"card": smi}
    if args.sass:
        csrc = REPO / "cpppathtracer_tpu_torch" / "csrc"
        report["sass"] = {"this": sass_loops(csrc), "parent": sass_loops(Path(args.sass).resolve())}
        for k, loops in report["sass"].items():
            for n, c in enumerate(loops):
                print(f"[sass] {k} winner_index_kernel inner loop {n}: {c['instructions']} "
                      f"instructions, in blocks a warp vote may skip {c['voted_blocks']} "
                      f"({c['when_skipped']} when all are skipped); {c['by_opcode']}", flush=True)

    if args.reps > 0:
        time_variants(args.reps, report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
