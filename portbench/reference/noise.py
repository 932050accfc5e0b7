"""The tracker's random draws, worked out again from (seed, frame index).

Frozen copy of the arithmetic in
``vitparticlefiltertracker_tpu_torch/filters/particle.py`` (``_splitmix64``,
``make_generator``, ``draw_step_noise``, the initial cloud of
``init_state``): a counter-based ``torch.Generator`` a draw, seeded with
splitmix64(splitmix64(seed) ^ stream), then the normals and the uniform in a
fixed order. The numbers come from torch's generator on the device given,
so a draw on the card equals the program's draw on the card. Plain torch;
imports nothing of the program.
"""

from __future__ import annotations

import torch

M64 = 0xFFFFFFFFFFFFFFFF
INIT_STREAM = 0xFFFFFFFF  # the initial cloud's stream


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(splitmix64(splitmix64(int(seed) & M64) ^ (int(stream) & M64)))
    return g


def step_noise(seed: int, frame_idx: int, n: int, device) -> dict:
    """One filter's draws for the step that leaves frame index `frame_idx`:
    pos [N, 2], vel [N, 2], scale [N] standard normals, u [] uniform."""
    g = generator(seed, frame_idx, device)
    return {
        "pos": torch.randn((n, 2), generator=g, device=device, dtype=torch.float32),
        "vel": torch.randn((n, 2), generator=g, device=device, dtype=torch.float32),
        "scale": torch.randn((n,), generator=g, device=device, dtype=torch.float32),
        "u": torch.rand((), generator=g, device=device, dtype=torch.float32),
    }


def init_cloud(seed: int, center: torch.Tensor, n: int, sigma_pos: float, sigma_vel: float) -> torch.Tensor:
    """The initial particles [N, 5] (x, y, vx, vy, log_s) around `center`."""
    g = generator(seed, INIT_STREAM, center.device)
    p = torch.zeros((n, 5), dtype=torch.float32, device=center.device)
    p[:, 0:2] = center.float()[None, :] + sigma_pos * torch.randn((n, 2), generator=g, device=center.device)
    p[:, 2:4] = sigma_vel * torch.randn((n, 2), generator=g, device=center.device)
    return p
