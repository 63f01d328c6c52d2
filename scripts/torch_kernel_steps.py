"""What each design step of the megakernel (#1), the dense winner kernel
(#2-#4) and the denoiser (#9) buys, on one NVIDIA card.

    python3 scripts/torch_kernel_steps.py [--kernel mega|denoise] [--reps 3]
                                          [--sass PARENT_CSRC] [--out FILE]

(`--reps 0 --sass PARENT_CSRC`: the SASS counts alone.)

The kernels' design steps, and the edit of the package's sources in
``cpppathtracer_tpu_torch/csrc`` that turns each off (:data:`STEP_EDITS`),
for ``--kernel mega`` (the default):

  early_exit  a path ends at its first miss (#1; off: every lane runs
              every bounce)
  warp_skip   a warp skips per-object work no lane needs (winner.cuh;
              off: the vote is always true)
  row16       rows read with two 16-byte shared loads (winner.cuh; off:
              eight 4-byte loads)

and for ``--kernel denoise`` (csrc/denoise.cuh says why each is bitwise):

  fixed_step  stepwidth 1 is a template instance with constant tap
              offsets (off: the tiled kernel reads the stepwidth at run
              time)
  float4      a staged pixel is two 16-byte words (off: seven float
              planes, seven 4-byte loads a tap)
  interior    blocks inside the image test no bounds (off: every block
              tests every tap)
  pairs       each pair's weight factor computed once, staged in shared
              memory (off: every pixel computes its 25)
  strips      a thread takes several pixels (and pair factors' positions)
              down a column and reads the rows they share once (off: one
              a thread, twice the threads a block)

For each variant (all steps off; each step alone; all on, the package's
sources as they are; all on but one) the script copies the sources into a
temporary directory, makes the edits of the steps that are off there and
builds the kernel's units (``mega_trace.cu`` and ``winner.cu``, or
``denoise.cu``) into a library of their own, all builds started together,
with the package's nvcc flags.  The package's wrappers launch each variant
in turn (the script points their library at it).  Every variant's outputs
must equal the package's bitwise (the denoiser's: ``denoise_plain``'s, NaN
where it is NaN).  It times every variant in turns (the order reversed on
every other round) at the main path's shapes.  The megakernel: by CUDA
events, ``mega_trace`` phase A + B of one 1024^2 x d8 sample of
demo_scene(0) with the bench camera, in both forms, and ``winner_index``
on the 1024^2 primaries of big_scene(4096); beside them, with the
package's kernels, the same sample traced unsplit (one launch of depth 8
over every lane, which the early exit makes do the same searches as phase
A + B).  The denoiser: a CUDA graph of 100 launches timed by events, at
stepwidth 1 on the buffers of a 1280x720 progressive frame of
demo_scene(0) (1 spp x d8) and on seeded random 1024^2 buffers (the video
frame), each variant checked at stepwidths 1 (its tiled kernel) and 2
(the untiled kernel of other stepwidths) on both.  It prints
each variant's registers and spills (ptxas), its median times and the
card's name and power limit, and keeps them as JSON with `--out`.

With `--sass`, for the megakernel it also counts the SASS instructions of
each innermost loop of ``winner.cu``'s kernel (``cuobjdump -sass`` of the
kernel built as the package builds it): the search loops over the
spheres, the platforms and the cylinders, one object an iteration unless
the compiler unrolled one (its MUFU count, one square root a sphere, one
reciprocal a platform, three a cylinder, says how often), with the
instructions inside the blocks a warp vote lets a warp skip; for this
checkout and for the sources in PARENT_CSRC (the parent's search, which
has no votes).  For the denoiser, each variant's build prints the opcode
counts of the instance that stepwidth 1 launches, and `--sass` adds the
parent's kernel's.
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

# step -> the edits that turn it off: (source file, the package's text, the text with the
# step off), made in order
STEP_EDITS = {
    "early_exit": (("mega_trace.cu",
                    "const bool stop = !hit && (tmin != 0.0f || best_t > POCA_TMIN_BOUNCE);",
                    "const bool stop = false;"),),
    "warp_skip": (("winner.cuh",
                   "  return __any_sync(0xffffffffu, pred);",
                   "  return true;"),),
    "row16": (("winner.cuh",
               "  return {rows[2 * j], rows[2 * j + 1]};",
               "  const float* g = reinterpret_cast<const float*>(rows) + 8 * j;\n"
               "  return {make_float4(g[0], g[1], g[2], g[3]), make_float4(g[4], g[5], g[6], g[7])};"),),
    "fixed_step": (("denoise.cu",
                    "  if (step == 1) return dn_launch<1, kPairs>(a, step, stream);",
                    "  if (step == 1) return dn_launch<0, kPairs>(a, step, stream);"),),
    "float4": (("denoise.cuh",
                "POCA_DN_HD void dn_put(float4* sm, int tnp, int k, const DnPix& v) {\n"
                "  sm[k] = make_float4(v.c0, v.c1, v.c2, v.d);\n"
                "  sm[tnp + k] = make_float4(v.n0, v.n1, v.n2, 0.f);\n"
                "}\n"
                "\n"
                "POCA_DN_HD DnPix dn_get(const float4* sm, int tnp, int k) {\n"
                "  const float4 a = sm[k], b = sm[tnp + k];\n"
                "  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z};\n"
                "}\n"
                "\n"
                "POCA_DN_HD float4 dn_get_c(const float4* sm, int tnp, int k) { return sm[k]; }",
                "POCA_DN_HD void dn_put(float4* sm, int tnp, int k, const DnPix& v) {\n"
                "  float* const f = reinterpret_cast<float*>(sm);\n"
                "  f[k] = v.c0; f[tnp + k] = v.c1; f[2 * tnp + k] = v.c2; f[3 * tnp + k] = v.d;\n"
                "  f[4 * tnp + k] = v.n0; f[5 * tnp + k] = v.n1; f[6 * tnp + k] = v.n2;\n"
                "}\n"
                "POCA_DN_HD DnPix dn_get(const float4* sm, int tnp, int k) {\n"
                "  const float* const f = reinterpret_cast<const float*>(sm);\n"
                "  return {f[k], f[tnp + k], f[2 * tnp + k], f[3 * tnp + k], f[4 * tnp + k],\n"
                "          f[5 * tnp + k], f[6 * tnp + k]};\n"
                "}\n"
                "POCA_DN_HD float4 dn_get_c(const float4* sm, int tnp, int k) {\n"
                "  const float* const f = reinterpret_cast<const float*>(sm);\n"
                "  return make_float4(f[k], f[tnp + k], f[2 * tnp + k], 0.f);\n"
                "}"),),
    "interior": (("denoise.cu",
                  "  const bool interior = dn_interior(a, g, blockIdx.x, blockIdx.y);",
                  "  const bool interior = false;"),),
    "pairs": (("denoise.cu", "  constexpr bool kPairs = true;", "  constexpr bool kPairs = false;"),),
    "strips": (("denoise.cuh", "#define DN_V 2", "#define DN_V 1"),
               ("denoise.cuh",
                "POCA_DN_HD constexpr int dn_strip(int S) { return S == 1 ? 3 : 2; }",
                "POCA_DN_HD constexpr int dn_strip(int S) { return 1; }")),
}
# kernel -> its steps, the units built, and the C entry points of the units
KERNELS = {
    "mega": dict(steps=("early_exit", "warp_skip", "row16"), units=("mega_trace.cu", "winner.cu"),
                 entries=("poca_mega_trace", "poca_mega_info", "poca_smem_optin",
                          "poca_winner_index", "poca_winner_info")),
    "denoise": dict(steps=("fixed_step", "float4", "interior", "pairs", "strips"),
                    units=("denoise.cu",),
                    entries=("poca_denoise",)),
}
W = H = 1024
DEPTH = 8
CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))


def variants(steps):
    """name -> the steps that are off"""
    out = {"all_off": steps}
    out.update({f"only_{s}": tuple(x for x in steps if x != s) for s in steps})
    out["package"] = ()
    out.update({f"no_{s}": (s,) for s in steps})
    return out


def build_variant(kernel, off, root):
    """Build the kernel's units from a copy of the package's sources under
    `root` with the steps in `off` turned off; returns (library path,
    ptxas report)."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    csrc = Path(root) / "csrc"
    shutil.copytree(kb.CSRC, csrc)
    for step in off:
        for name, old, new in STEP_EDITS[step]:
            text = (csrc / name).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"step {step}: its text is not in {name} exactly once")
            (csrc / name).write_text(text.replace(old, new))
    nvcc = kb._nvcc()
    units = KERNELS[kernel]["units"]
    objs = [Path(root) / (Path(u).stem + ".o") for u in units]
    procs = [subprocess.Popen([nvcc, *kb.NVCC_FLAGS, "-I", str(csrc), "-c", str(csrc / u),
                               "-o", str(o)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for u, o in zip(units, objs)]
    report = ""
    for u, proc in zip(units, procs):
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {u} (off: {off}):\n{text}")
        report += text
    lib = Path(root) / "libsteps.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return lib, report


def load(kernel, lib_path):
    """The variant's library, its C entry points typed as the package types
    them."""
    import ctypes

    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    lib = ctypes.CDLL(str(lib_path))
    for name in KERNELS[kernel]["entries"]:
        fn = getattr(lib, name)
        fn.argtypes = kb._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def ptxas_entries(text):
    """{kernel entry: {"registers", "spill_stores", "spill_loads"}} from a
    ptxas report"""
    out, entry, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = dict(registers=int(m.group(1)), spill_stores=spills[0],
                              spill_loads=spills[1])
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

def _parse_sass(text, full=False):
    """{function: [(address, opcode, predicated, branch target or None)]}
    from ``cuobjdump -sass`` (or ``nvdisasm``) text, NOPs left out; the
    opcode without its modifiers, or with them (`full`: LDS.128)."""
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
            funcs[name].append((addr, op if full else op.split(".")[0], bool(m.group(2)), target))
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


def cubin_sass(csrc, unit):
    """cuobjdump -sass of one unit of `csrc`, built as the package builds it."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    nvcc = kb._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "unit.cubin"
        flags = [f for f in kb.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([nvcc, *flags, "-cubin", "-I", str(csrc), "-o", str(cubin),
                        str(Path(csrc) / unit)], check=True, capture_output=True, text=True)
        return subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                              text=True).stdout


def sass_loops(csrc):
    """The innermost loops of csrc/winner.cu's kernel (its search loops
    over the spheres, platforms and cylinders, in that order, and its
    staging loop), built as the package builds it."""
    text = cubin_sass(csrc, "winner.cu")
    (body,) = [b for f, b in _parse_sass(text).items() if "winner_index_kernel" in f]
    return inner_loops(body)


def time_variants(kernel, reps, report):
    """Build every variant, check it against the package's kernels and time
    them all in turns; their registers and times go into `report`."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    t0 = time.perf_counter()
    kb.library()  # the package's full library: the inputs use its compaction / render
    var = variants(KERNELS[kernel]["steps"])
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(var)) as pool:
        built = dict(zip(var, pool.map(lambda kv: build_variant(kernel, kv[1], Path(tmp) / kv[0]),
                                       var.items())))
        print(f"[build] {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        libs = {name: load(kernel, path) for name, (path, _) in built.items()}
        report["ptxas"] = {name: ptxas_entries(text) for name, (_, text) in built.items()}
        for name, regs in report["ptxas"].items():
            print(f"[ptxas] {name} (off: {', '.join(var[name]) or 'none'}): {regs}", flush=True)
        if kernel == "denoise":
            report["sass"] = {name: denoise_sass(path, var[name])
                              for name, (path, _) in built.items()}
            for name, c in report["sass"].items():
                print(f"[sass] {name}: {c['function']}: {c['instructions']} instructions, "
                      f"{c['fp32']} on the FP32 pipe, MUFU {c['MUFU']}, LDS {c['LDS']} "
                      f"(of them LDS.128 {c['LDS.128']}); loops {c['loops']}; "
                      f"opcodes {c['top']}", flush=True)
            results = run_denoise(libs, reps)
        else:
            results = run_all(libs, reps)
    report["ms"] = {name: {k: statistics.median(v) for k, v in r.items()} for name, r in results.items()}
    report["runs"] = results
    for name, r in report["ms"].items():
        print(f"[median] {name}: " + ", ".join(f"{k} {v:.5f} ms" for k, v in r.items()), flush=True)
    print(json.dumps(report["ms"]), flush=True)


# ------------------------------------------------------------------ the denoiser

DN_W, DN_H = 1280, 720  # the progressive frame
DN_VIDEO = 1024  # the video frame


def graph_ms(fn, n=100, replays=5):
    """Device ms a call of fn() from one CUDA graph of n calls, timed by
    CUDA events over `replays` replays (fn is called once eagerly first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * n)
    graph.reset()
    return ms


def denoise_inputs(dev):
    """{case: (radiance, normal, depth)}: a 1280x720 progressive frame's
    buffers (demo_scene(0), 1 spp x d8, the bench camera) and seeded
    random 1024^2 buffers."""
    import torch

    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    scene = demo_scene(0).build(device=dev)
    cam = Camera.make(DN_W, DN_H, device=dev, **CAMERA)
    sky = torch.from_numpy(procedural_sky(256, 256)).to(dev)
    with torch.no_grad():
        rad, nrm, dep = render_radiance(scene, cam, sky, spp=1, max_depth=DEPTH, seed=0)
    g = torch.Generator(device=dev).manual_seed(14)
    n = DN_VIDEO
    return {f"frame {DN_W}x{DN_H}": (rad.reshape(DN_H, DN_W, 3), nrm.reshape(DN_H, DN_W, 3),
                                     dep.reshape(DN_H, DN_W)),
            f"random {n}x{n}": (2 * torch.rand((n, n, 3), device=dev, generator=g),
                                torch.randn((n, n, 3), device=dev, generator=g),
                                50 * torch.rand((n, n), device=dev, generator=g))}


def same_bits(a, b):
    """Equal bit for bit where neither is NaN, NaN in the same places."""
    import torch

    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def run_denoise(libs, reps):
    """Each variant's outputs at stepwidths 1 and 2 against denoise_plain's,
    and its graph time at stepwidth 1, in turns."""
    import torch

    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise, denoise_plain

    cases = denoise_inputs(torch.device("cuda"))
    refs = {(c, step): denoise_plain(*args, step) for c, args in cases.items() for step in (1, 2)}
    for name, lib in libs.items():
        with launching(lib):
            for (c, step), ref in refs.items():
                if not same_bits(denoise(*cases[c], step), ref):
                    raise SystemExit(f"variant {name} differs from denoise_plain on {c}, "
                                     f"stepwidth {step}")
    print(f"[check] all {len(libs)} variants bitwise equal to denoise_plain on "
          f"{', '.join(cases)} at stepwidths 1 and 2", flush=True)
    results = {name: {c: [] for c in cases} for name in libs}
    for rnd in range(reps):
        for name in (list(libs) if rnd % 2 == 0 else list(reversed(libs))):
            with launching(libs[name]):
                for c, args in cases.items():
                    results[name][c].append(graph_ms(lambda: denoise(*args, 1)))
            print(f"[round {rnd + 1}] {name}: " + ", ".join(
                f"{c} {v[-1]:.5f} ms" for c, v in results[name].items()), flush=True)
    return results


def denoise_function(off):
    """The mangled name of the instance that stepwidth 1 launches in a
    variant with the steps in `off` turned off."""
    s = 0 if "fixed_step" in off else 1
    return f"_Z14denoise_kernelILi{s}ELb{0 if 'pairs' in off else 1}EEvPKfS1_S1_Pfiii"


def denoise_sass(lib_path, off):
    """Opcode counts of the stepwidth-1 instance's SASS in a variant's
    library (static: each instruction once, both the interior and the edge
    body), its LDS split by width, and the size of each innermost loop (the
    staging loop and the pair factors' loop, each run about tn / 512 and
    rn / 512 times a thread)."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    cuobjdump = str(Path(kb._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True).stdout
    return sass_summary(text, denoise_function(off))


def sass_summary(text, name):
    """sass_summary of function `name` in cuobjdump's text."""
    body = _parse_sass(text, full=True)[name]
    ops = {}
    for _, o, _, _ in body:
        ops[o] = ops.get(o, 0) + 1
    base = {}
    for o, n in ops.items():
        base[o.split(".")[0]] = base.get(o.split(".")[0], 0) + n
    return dict(function=name, instructions=len(body),
                fp32=sum(base.get(o, 0) for o in ("FADD", "FMUL", "FFMA", "FMNMX")),
                MUFU=base.get("MUFU", 0), LDS=base.get("LDS", 0),
                **{"LDS.128": sum(n for o, n in ops.items() if o.startswith("LDS.") and "128" in o)},
                loops=[c["instructions"] for c in inner_loops(_parse_sass(text)[name])],
                by_opcode=dict(sorted(base.items())),
                top=dict(sorted(base.items(), key=lambda kv: -kv[1])[:14]))


def parent_denoise_sass(csrc):
    """sass_summary of the stepwidth-1 denoise kernel built from another
    checkout's sources (a parent's single kernel, or its instance <1, ...>)."""
    text = cubin_sass(csrc, "denoise.cu")
    names = [f for f in _parse_sass(text) if "denoise_kernel" in f]
    name = next((f for f in names if "ILi1E" in f), names[0])
    return sass_summary(text, name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="mega")
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
    report = {"card": smi, "kernel": args.kernel}
    if args.sass and args.kernel == "mega":
        csrc = REPO / "cpppathtracer_tpu_torch" / "csrc"
        report["sass"] = {"this": sass_loops(csrc), "parent": sass_loops(Path(args.sass).resolve())}
        for k, loops in report["sass"].items():
            for n, c in enumerate(loops):
                print(f"[sass] {k} winner_index_kernel inner loop {n}: {c['instructions']} "
                      f"instructions, in blocks a warp vote may skip {c['voted_blocks']} "
                      f"({c['when_skipped']} when all are skipped); {c['by_opcode']}", flush=True)
    if args.sass and args.kernel == "denoise":
        report["parent_sass"] = parent_denoise_sass(Path(args.sass).resolve())
        print(f"[sass] parent: {report['parent_sass']}", flush=True)

    if args.reps > 0:
        time_variants(args.kernel, args.reps, report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
