"""Device time a dispatch in the model's elementwise and reduction tail:
kernels that are not matrix products, K1, K2 or NCCL (copies and memsets
are not kernels), classified by name with the table below, in ms."""

# Substrings of kernel names (lower case) that are not the tail.
NOT_TAIL = (
    "gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce",  # cuBLAS and CUTLASS products
    "attn_small_kernel", "attn_tiled_bf16_kernel", "attn_tiled_f32_kernel",  # K1
    "window_patchify",  # K2
    "nccl",  # collectives
)


def read(run):
    sl = run.slice
    if sl is None or not sl.dispatches:
        return None
    tail = sl.device_s(lambda name: not any(k in name.lower() for k in NOT_TAIL))
    return tail / sl.dispatches * 1e3
