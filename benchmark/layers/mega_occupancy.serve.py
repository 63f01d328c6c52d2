"""mega_occupancy.serve: kernel #1's resident warps an SM over the 64 an
H100 SM holds, in %, from the launch shape the port counts on its serving
entry span (`render.call`'s `mega_blocks_sm`: blocks of 128 threads, as
`csrc/mega_trace.cu` launches them, resident on one SM) over the traced
window's renders; nothing where the port records no such count."""

from benchmark.harness import program_spans

BLOCK_WARPS = 128 // 32  # csrc/mega_trace.cu's POCA_MEGA_BLOCK threads, in warps
SM_WARPS = 64  # the resident warps an SM of compute capability 9.0 holds


def read(view):
    got = program_spans.window(view, ("render.call",))
    if got is None:
        return None
    blocks = [r["counts"]["mega_blocks_sm"] for r in got[1]
              if r["name"] == "render.call" and "mega_blocks_sm" in r["counts"]]
    if not blocks:
        return None
    return 100.0 * BLOCK_WARPS * sum(blocks) / len(blocks) / SM_WARPS
