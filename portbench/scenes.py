"""Synthetic tracking clips, made on the device from a seed.

Frozen copy of the scenes ``moving-square``, ``occlusion`` and ``needle`` of
``vitparticlefiltertracker_tpu_torch/io/synthetic.py`` (``make_clip``): a
low-frequency textured background, a smooth radial-gradient target on a
linear plus sinusoidal path, per-frame sensor noise, and for ``occlusion``
a grey bar sweeping over the target for a sixth of the clip. The geometry
and the value ranges are the program's; the random numbers are torch's, on
the device (one draw of the background's control points, one of the noise
a block of frames), so a 1080p clip takes a fraction of a second, not the
host's minutes.
"""

from __future__ import annotations

import numpy as np
import torch

SCENES = ("moving-square", "occlusion", "needle")


def _background(g: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    """[H, W, 3] float32: control points uniform in [40, 200] every 16 px,
    bilinearly interpolated."""
    small = 40.0 + 160.0 * torch.rand((h // 16 + 2, w // 16 + 2, 3), generator=g, device=device)
    ys = torch.linspace(0, small.shape[0] - 1.001, h, device=device, dtype=torch.float64)
    xs = torch.linspace(0, small.shape[1] - 1.001, w, device=device, dtype=torch.float64)
    y0, x0 = ys.long(), xs.long()
    fy, fx = (ys - y0)[:, None, None].float(), (xs - x0)[None, :, None].float()
    s = small
    a = s[y0][:, x0] * (1 - fy) * (1 - fx) + s[y0][:, x0 + 1] * (1 - fy) * fx
    b = s[y0 + 1][:, x0] * fy * (1 - fx) + s[y0 + 1][:, x0 + 1] * fy * fx
    return a + b


def _pattern(th: int, tw: int, device) -> torch.Tensor:
    """The target's [th, tw, 3] radial colour gradient (bright warm core,
    bluish rim)."""
    yy, xx = torch.meshgrid(torch.arange(th, device=device, dtype=torch.float32),
                            torch.arange(tw, device=device, dtype=torch.float32), indexing="ij")
    ry = (yy - (th - 1) / 2) / (th / 2)
    rx = (xx - (tw - 1) / 2) / (tw / 2)
    r = torch.sqrt(rx ** 2 + ry ** 2)
    core = torch.clamp(1.0 - r, 0.0, 1.0)
    return torch.stack([40 + 215 * core, 30 + 120 * core * core, 200 * torch.clamp(r - 0.3, 0, 1)], dim=-1)


def _paint(frame: torch.Tensor, cx: float, cy: float, w: int, h: int, pattern: torch.Tensor) -> None:
    hh, ww = frame.shape[:2]
    x0, y0 = int(round(cx - w / 2)), int(round(cy - h / 2))
    x1, y1 = x0 + int(w), y0 + int(h)
    sx0, sy0 = max(0, -x0), max(0, -y0)
    x0, y0, x1, y1 = max(0, x0), max(0, y0), min(ww, x1), min(hh, y1)
    if x1 > x0 and y1 > y0:
        frame[y0:y1, x0:x1] = pattern[sy0:sy0 + (y1 - y0), sx0:sx0 + (x1 - x0)]


def make_clip(name: str, num_frames: int, height: int, width: int, seed: int, device,
              block: int = 16) -> tuple[torch.Tensor, np.ndarray, tuple[int, int]]:
    """-> (frames [T, H, W, 3] uint8 on `device`, truth [T, 2] float32
    target centres (x, y), target size (w, h) px)."""
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; expected one of {SCENES}")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    bg = _background(g, height, width, device)
    scale = min(height, width) / 224.0
    if name == "needle":
        tw, th = max(8, int(60 * scale)), max(4, int(8 * scale))
    else:
        tw = th = max(8, int(32 * scale))
    pattern = _pattern(th, tw, device)
    margin = max(tw, th)
    cx0, cy0, speed, amp = width * 0.35, height * 0.4, 2.0 * scale, height * 0.12
    t = np.arange(num_frames)
    cx = np.clip(cx0 + speed * t, margin, width - margin)
    cy = np.clip(cy0 + amp * np.sin(2 * np.pi * t / max(30, num_frames)), margin, height - margin)
    occ = range(num_frames // 3, num_frames // 3 + max(5, num_frames // 6)) if name == "occlusion" else range(0)
    frames = torch.empty((num_frames, height, width, 3), dtype=torch.uint8, device=device)
    for b0 in range(0, num_frames, block):
        b1 = min(num_frames, b0 + block)
        f = bg[None] + 2.0 * torch.randn((b1 - b0, height, width, 3), generator=g, device=device)
        for i in range(b0, b1):
            _paint(f[i - b0], cx[i], cy[i], tw, th, pattern)
            if i in occ:
                ox = int(cx[i] - tw)
                f[i - b0, :, max(0, ox):max(0, ox) + 2 * tw] = 90.0
        frames[b0:b1] = torch.clamp(f, 0, 255).to(torch.uint8)
    return frames, np.stack([cx, cy], axis=1).astype(np.float32), (tw, th)
