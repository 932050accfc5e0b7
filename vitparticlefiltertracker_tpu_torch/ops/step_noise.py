"""The tracker step's noise drawn on the card: one kernel for all banks.

``step_noise`` wraps csrc/step_noise.cu, which writes a step's ``StepNoise``
(position, velocity and scale normals and the resampling uniform) and, when
asked, the re-detection reseed normals, for every bank and every step of a
chunk, in one launch. A captured step graph launches it ahead of the step
(runtime/step_graph.py), so the host hands over only the keys: a [K, 2]
int64 buffer of (seed, frame index) a bank.

The draws are bitwise those of filters/particle.py ``draw_step_noise`` and
``draw_reseed_noise`` on the card (a CUDA ``torch.Generator`` a bank and
torch's own draws), which stay the CPU's and the eager step's path and the
benchmark's reference. ``draw_plan`` is the part of torch's launches that
decides the bits (ATen/native/cuda/DistributionTemplates.h
``calc_execution_policy``): each draw's grid and the generator's Philox
offset at each draw, from the card's SMs and threads a SM. It is pure
Python, so the CPU tests reach it. There is no fallback: on CUDA buffers the
kernel launches or the call raises.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from vitparticlefiltertracker_tpu_torch.filters.particle import StepNoise
from vitparticlefiltertracker_tpu_torch.utils.platform import H100_SMS, sm_count

BLOCK = 256  # torch's block for its distribution kernels (block_size_bound), and this kernel's
CALL_OFFSETS = 4  # Philox offsets a curand_normal4 / curand_uniform4 call takes (a float4 a call)
H100_THREADS_PER_SM = 2048  # maxThreadsPerMultiProcessor on Hopper
_THREADS_PER_SM: dict[int, int] = {}  # device index -> threads a SM, read once


def launch_policy(numel: int, sms: int = H100_SMS, threads_per_sm: int = H100_THREADS_PER_SM) -> tuple[int, int]:
    """torch's launch of a float normal or uniform draw of `numel` elements
    -> (grid, the Philox offset it takes): blocks of 256 threads, at most
    a full card's worth, each thread making one float4 call a pass of its
    grid-stride loop."""
    grid = min(sms * (threads_per_sm // BLOCK), -(-numel // BLOCK))
    return grid, ((numel - 1) // (BLOCK * grid * CALL_OFFSETS) + 1) * CALL_OFFSETS


class DrawPlan(NamedTuple):
    grid2: int  # torch's grid for a draw of 2 N floats (pos, vel, reseed)
    grid1: int  # for a draw of N floats (scale); the uniform's is 1
    offsets: tuple[int, int, int, int, int]  # Philox offset at pos, vel, scale, resample_u; reseed (its own generator)


def draw_plan(n: int, sms: int = H100_SMS, threads_per_sm: int = H100_THREADS_PER_SM) -> DrawPlan:
    """The grids and offsets of one bank's draws for N particles, in
    draw_step_noise's order (pos [N, 2], vel [N, 2], scale [N], resample_u
    []) from a fresh generator at offset 0; the reseed's [N, 2] comes from
    a generator of its own, also at 0."""
    grid2, step2 = launch_policy(2 * n, sms, threads_per_sm)
    grid1, step1 = launch_policy(n, sms, threads_per_sm)
    return DrawPlan(grid2, grid1, (0, step2, 2 * step2, 2 * step2 + step1, 0))


def launch_blocks(items: int, sms: int = H100_SMS) -> int:
    """This kernel's grid for `items` work items (a torch thread of one
    bank's draw that writes an element): one item a thread, at most 8
    blocks of 256 a SM (the kernel loops over the rest)."""
    return min(-(-items // BLOCK), sms * (H100_THREADS_PER_SM // BLOCK))


def work_items(n: int, plan: DrawPlan, reseed: bool) -> int:
    """One bank's work items: each draw's threads that write an element."""
    two, one = min(2 * n, BLOCK * plan.grid2), min(n, BLOCK * plan.grid1)
    return 2 * two + one + 1 + (two if reseed else 0)


def threads_per_sm(device: torch.device) -> int:
    """A CUDA device's maxThreadsPerMultiProcessor, read once a process."""
    t = _THREADS_PER_SM.get(device.index)
    if t is None:
        props = torch.cuda.get_device_properties(device)
        t = _THREADS_PER_SM[device.index] = int(props.max_threads_per_multi_processor)
    return t


def _check(keys: torch.Tensor, noise: StepNoise, reseed: torch.Tensor | None) -> tuple[int, int, int]:
    """-> (C, K, N) from the buffers' shapes, or ValueError."""
    dev = keys.device
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2 or not keys.is_contiguous():
        raise ValueError(f"step_noise: keys must be a contiguous [K, 2] int64 tensor, got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    per = tuple(noise.resample_u.shape)
    n = noise.scale.shape[-1] if noise.scale.dim() else 0
    want = {"pos": (*per, n, 2), "vel": (*per, n, 2), "scale": (*per, n), "resample_u": per}
    bufs = dict(zip(StepNoise._fields, noise))
    if reseed is not None:
        want["reseed"], bufs["reseed"] = (*per, n, 2), reseed
    for name, x in bufs.items():
        if (tuple(x.shape) != want[name] or x.dtype != torch.float32 or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"step_noise: {name} must be a contiguous float32 {want[name]} tensor on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    k, banks = keys.shape[0], noise.resample_u.numel()
    if n < 1 or k < 1 or banks % k:
        raise ValueError(f"step_noise: {banks} banks' buffers of {n} particles for {k} keys")
    return banks // k, k, n


def step_noise(keys: torch.Tensor, noise: StepNoise, reseed: torch.Tensor | None = None) -> None:
    """Draw a step's noise on the card into the buffers given, on the
    current stream: noise's fields [C, K, ...] (or [K, ...], or [...] for
    one filter: the leading axes the tracker's buffers have), reseed
    [..., N, 2] or None (not drawn). keys: [K, 2] int64 (seed, frame index)
    a bank on the same card; step c of a chunk draws frame index + c. Bank
    (c, k)'s values equal draw_step_noise(seed_k, frame_k + c, N) and
    draw_reseed_noise(seed_k, frame_k + c, N) on the card, bit for bit.

    Adds one to ``step_noise.launches`` (and to
    ``step_noise.shapes[(C, K, N, reseed drawn)]``) a launch.
    """
    if not keys.is_cuda:
        raise ValueError("step_noise draws on the card; use filters/particle.py draw_step_noise on the CPU")
    c, k, n = _check(keys, noise, reseed)
    dev = keys.device
    sms = sm_count(dev)
    plan = draw_plan(n, sms, threads_per_sm(dev))
    blocks = launch_blocks(c * k * work_items(n, plan, reseed is not None), sms)
    from vitparticlefiltertracker_tpu_torch.ops._build import step_noise_library

    lib = step_noise_library()
    _, off_vel, off_scale, off_u, _ = plan.offsets
    with torch.cuda.device(dev):
        rc = lib.vpt_step_noise(
            keys.data_ptr(), c, k, n, *(x.data_ptr() for x in noise),
            None if reseed is None else reseed.data_ptr(), plan.grid2, plan.grid1, off_vel, off_scale, off_u,
            blocks, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vpt_step_noise failed with code {rc} (C {c}, K {k}, N {n})")
    step_noise.launches += 1
    step_noise.shapes[(c, k, n, reseed is not None)] += 1


step_noise.launches = 0
step_noise.shapes = Counter()
