"""The SwiGLU gate kernel (``ops/swiglu.py``, ``csrc/swiglu.cu``) against its
roofline: the least time of each traced launch over the launches' traced
device time, in %. A launch reads the [M, 2 h] bf16 output of the FFN's
first product and writes [M, h] bf16: M h 6 bytes, M the cell's feeds times
the window's tokens (the family's ``attention``: patches and prefix tokens),
h the FFN's hidden width (``mlp_dim``); its least time is those bytes at
HBM's peak (portbench/counts.py). At one feed of DINOv2 ViT-g/14 (M 261, h
4096): 6,414,336 bytes, 1.9 us. Launches are matched by the kernel's name;
a cell whose model has no SwiGLU FFN reads nothing."""

from portbench.counts import PEAK_HBM_BYTES

KERNELS = ("swiglu_bf16_kernel", "swiglu_f32_kernel")


def launch_bytes(m: int, h: int, itemsize: int = 2) -> int:
    """[M, 2 h] read and [M, h] written."""
    return m * 2 * h * itemsize + m * h * itemsize


def read(run):
    sl = run.slice
    if sl is None:
        return None
    launches = [(s, e) for name, s, e, _ in sl.kernels if any(k in name for k in KERNELS)]
    if not launches:
        return None
    _, t, _ = run.family.attention(run.cfg["dims"], run.cfg["tracker_config"])
    least_s = launch_bytes(run.feeds * t, run.cfg["dims"]["mlp_dim"]) / PEAK_HBM_BYTES
    spent = sum(e - s for s, e in launches) * 1e-6
    return 100.0 * len(launches) * least_s / spent
