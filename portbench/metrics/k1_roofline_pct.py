"""Kernel K1 (``ops/attention.py``, ``csrc/flash_attn.cu``) against its
roofline: the least time of each traced launch (the larger of its FLOPs
over the bf16 peak and its bytes over HBM's, portbench/counts.py) over the
launches' traced device time, in %. A launch's shape is the cell's
[feeds, heads, tokens, head dim], the last three from the configuration's
model family (``attention``), matched by the grid the trace records;
launches of another grid are left out of both sums."""

from portbench.counts import k1_grid, k1_least_s

K1_KERNELS = ("attn_small_kernel", "attn_tiled_bf16_kernel", "attn_tiled_f32_kernel")


def read(run):
    sl = run.slice
    if sl is None:
        return None
    b, (h, t, dh) = run.feeds, run.family.attention(run.cfg["dims"], run.cfg["tracker_config"])
    grid = k1_grid(b, h, t)
    launches = [(s, e) for name, s, e, g in sl.kernels
                if any(k in name for k in K1_KERNELS) and g and int(g[0]) == grid]
    if not launches:
        return None
    spent = sum(e - s for s, e in launches) * 1e-6
    return 100.0 * len(launches) * k1_least_s(b, h, t, dh) / spent
