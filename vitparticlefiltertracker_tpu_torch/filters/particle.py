"""Particle filter core: propagation, weighting, estimation, ESS-gated
systematic resampling — the port of the JAX package's ``filters/particle.py``.

The resample branch is computed unconditionally and selected with
``torch.where``, as in the JAX version, so one step never branches on device
data. Noise comes from a ``torch.Generator`` seeded from (seed, frame index),
so a trajectory is reproducible and a resumed run continues it exactly. A
``StepNoise`` (and the initial cloud) can also be injected, which is how the
tests feed both packages the same draws.

Where the draws are made: ``draw_step_noise`` and ``draw_reseed_noise`` run
on the host's call on the CPU and in the eager step (runtime/tracker.py
``_GraphStepper._host_draws``). On the card the step's CUDA graph draws them
itself, every bank in one kernel (ops/step_noise.py, csrc/step_noise.cu),
from the (seed, frame index) keys the host copies in before each replay:
the same bits as these functions give on the card, since that kernel redoes
torch's Philox launches for each draw.

State layout: particles[..., 5] = [x, y, vx, vy, log_s]. Every function
takes optional leading axes (K filter banks: particles [K, N, 5], weights
[K, N]); each bank reduces over its own particles only.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from vitparticlefiltertracker_tpu_torch.ops.resample import systematic_resample_indices

STATE_DIM = 5
# Frame index used for the initial cloud's generator (the JAX package folds
# 0xFFFFFFFF into its key for the same draw).
INIT_STREAM = 0xFFFFFFFF
# Global re-detection's reseed draw at frame i comes from stream
# RESEED_STREAM | i. Step noise uses streams 0 .. 2**31 - 1 (the int32 frame
# index) and the initial cloud 2**32 - 1, so no stream is shared. (The JAX
# package folds 0x5EED1 into its frame key for the same draw.)
RESEED_STREAM = 1 << 32


class MotionParams(NamedTuple):
    sigma_pos: float = 4.0
    sigma_vel: float = 1.0
    sigma_scale: float = 0.0
    vel_decay: float = 0.95


class PFParams(NamedTuple):
    motion: MotionParams = MotionParams()
    ess_threshold: float = 0.5
    init_sigma_pos: float = 2.0
    init_sigma_vel: float = 1.0


class PFState(NamedTuple):
    particles: torch.Tensor  # [..., N, 5] float32
    log_weights: torch.Tensor  # [..., N] float32, normalized (logsumexp == 0)


class StepNoise(NamedTuple):
    """One frame's random draws, in the JAX package's order (a leading K
    axis for K banks)."""

    pos: torch.Tensor  # [..., N, 2] standard normal
    vel: torch.Tensor  # [..., N, 2] standard normal
    scale: torch.Tensor  # [..., N] standard normal
    resample_u: torch.Tensor  # [...] uniform [0, 1)


_M64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def make_generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator keyed on (seed, stream): counter-based, so frame i's draws
    do not depend on how many frames ran before it in this process.

    The pair is hashed (splitmix64) into one 64-bit seed, because the CPU
    generator keeps only the low 32 bits of what it is given.
    """
    g = torch.Generator(device=device)
    g.manual_seed(_splitmix64(_splitmix64(int(seed) & _M64) ^ (int(stream) & _M64)))
    return g


def _per_bank(seeds: Sequence[int], frame_idx) -> list[tuple[int, int]]:
    """(seed, frame index) a bank: one frame index for all, or one each."""
    idx = list(frame_idx) if isinstance(frame_idx, (list, tuple)) else [frame_idx] * len(seeds)
    if len(idx) != len(seeds):
        raise ValueError(f"{len(seeds)} seeds but {len(idx)} frame indices")
    return list(zip(seeds, idx))


def draw_step_noise(
    seed: int | Sequence[int], frame_idx: int | Sequence[int], n: int, device: torch.device, dtype=torch.float32
) -> StepNoise:
    """Fixed draw order: pos, vel, scale normals, then the resampling uniform.

    A list of seeds (and of frame indices, or one for all) gives K banks'
    draws stacked on a leading axis: bank k's are those a single filter with
    seed k at its frame index draws."""
    if isinstance(seed, (list, tuple)):
        draws = [draw_step_noise(s, i, n, device, dtype) for s, i in _per_bank(seed, frame_idx)]
        return StepNoise(*(torch.stack(x) for x in zip(*draws)))
    g = make_generator(seed, frame_idx, device)
    return StepNoise(
        pos=torch.randn((n, 2), generator=g, device=device, dtype=dtype),
        vel=torch.randn((n, 2), generator=g, device=device, dtype=dtype),
        scale=torch.randn((n,), generator=g, device=device, dtype=dtype),
        resample_u=torch.rand((), generator=g, device=device, dtype=dtype),
    )


def draw_reseed_noise(
    seed: int | Sequence[int], frame_idx: int | Sequence[int], n: int, device: torch.device
) -> torch.Tensor:
    """[N, 2] standard normals for global re-detection's reseed at a frame
    ([K, N, 2] for a list of seeds, as draw_step_noise)."""
    if isinstance(seed, (list, tuple)):
        return torch.stack([draw_reseed_noise(s, i, n, device) for s, i in _per_bank(seed, frame_idx)])
    g = make_generator(seed, RESEED_STREAM | int(frame_idx), device)
    return torch.randn((n, 2), generator=g, device=device, dtype=torch.float32)


def init_state(
    seed: int | Sequence[int],
    center: torch.Tensor,
    n: int,
    params: PFParams,
    dtype=torch.float32,
    cloud: torch.Tensor | None = None,
) -> PFState:
    """Particle cloud around the initial bbox center.

    cloud: optional injected [N, 5] particles (parity runs); otherwise the
    positions and velocities are drawn from the (seed, INIT_STREAM) generator.
    A list of K seeds and centers [K, 2] give K banks' clouds stacked.
    """
    device = center.device
    if isinstance(seed, (list, tuple)) and cloud is None:
        states = [init_state(s, c, n, params, dtype) for s, c in zip(seed, center.unbind(0), strict=True)]
        return PFState(*(torch.stack(x) for x in zip(*states)))
    if cloud is None:
        g = make_generator(seed, INIT_STREAM, device)
        p = torch.zeros((n, STATE_DIM), dtype=dtype, device=device)
        p[:, 0:2] = center.to(dtype)[None, :] + params.init_sigma_pos * torch.randn(
            (n, 2), generator=g, device=device, dtype=dtype
        )
        p[:, 2:4] = params.init_sigma_vel * torch.randn(
            (n, 2), generator=g, device=device, dtype=dtype
        )
    else:
        p = cloud.to(device=device, dtype=dtype)
    logw = torch.full(p.shape[:-1], -math.log(n), dtype=dtype, device=device)
    return PFState(particles=p, log_weights=logw)


def propagate(particles: torch.Tensor, noise: StepNoise, motion: MotionParams) -> torch.Tensor:
    """x' = x + v + sigma_pos*eps; v' = decay*v + sigma_vel*eps; log_s' += sigma_s*eps."""
    pos = particles[..., 0:2] + particles[..., 2:4] + motion.sigma_pos * noise.pos
    vel = motion.vel_decay * particles[..., 2:4] + motion.sigma_vel * noise.vel
    log_s = particles[..., 4] + motion.sigma_scale * noise.scale
    return torch.cat([pos, vel, log_s[..., None]], dim=-1)


def normalize_log_weights(log_weights: torch.Tensor) -> torch.Tensor:
    return log_weights - torch.logsumexp(log_weights, dim=-1, keepdim=True)


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    w = torch.exp(normalize_log_weights(log_weights))
    return 1.0 / torch.sum(w * w, dim=-1)


def estimate_state(particles: torch.Tensor, log_weights: torch.Tensor) -> torch.Tensor:
    """Posterior weighted-mean state — the per-frame tracked position."""
    w = torch.exp(normalize_log_weights(log_weights))
    return torch.sum(w[..., None] * particles, dim=-2)


class StepOut(NamedTuple):
    state: PFState
    estimate: torch.Tensor  # [..., 5] posterior mean state
    ess: torch.Tensor  # [...] effective sample size (post-weight, pre-resample)
    resampled: torch.Tensor  # [...] bool


def pf_update(
    particles: torch.Tensor,
    log_weights: torch.Tensor,
    log_likelihood: torch.Tensor,
    resample_u: torch.Tensor,
    params: PFParams,
) -> StepOut:
    """Weight -> estimate -> ESS-gated resample on already-propagated
    particles, each bank of a leading axis on its own."""
    n = particles.shape[-2]
    dtype = particles.dtype

    log_w = normalize_log_weights(log_weights + log_likelihood.to(dtype))
    est = estimate_state(particles, log_w)

    ess = effective_sample_size(log_w)
    do_resample = ess < params.ess_threshold * n

    w = torch.exp(log_w)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    res_idx = systematic_resample_indices(w, resample_u)
    keep = torch.arange(n, device=particles.device)
    idx = torch.where(do_resample[..., None], res_idx, keep)
    new_particles = torch.gather(particles, -2, idx[..., None].expand(particles.shape))
    uniform = torch.full((n,), -math.log(n), dtype=dtype, device=particles.device)
    new_log_w = torch.where(do_resample[..., None], uniform, log_w)

    return StepOut(
        state=PFState(particles=new_particles, log_weights=new_log_w),
        estimate=est,
        ess=ess,
        resampled=do_resample,
    )
