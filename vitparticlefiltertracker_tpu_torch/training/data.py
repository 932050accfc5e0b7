"""Procedural scene pairs for feature training, made on the device — the port
of the JAX package's ``training/data.py``.

A pair is (frame0, frame1) with a known target box: frame0 gives the
template view, frame1 the search view after motion, photometric jitter, a
camera shift, a distractor object (a lookalike clone of the target in a
fraction of the pairs) and sometimes a partial occluder; frame2 is frame1's
scene with the target removed. The trainer teaches the embedder that the true
box in frame1 matches the template better than offset, background and
distractor boxes.

The JAX package's ``_synth_pair`` is split in two here. ``draw_scene`` makes
every random draw of a batch (each the value a ``jax.random`` call of
``_synth_pair`` returns, or the outcome of its comparison with a
probability) from a ``torch.Generator``; ``render_scene`` turns them into
the pair, deterministically and batched over B. So the tests can render the
JAX package's own draws, and a run's scenes are a function of its
generator's seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vitparticlefiltertracker_tpu_torch.ops.image import extract_window_mxu


class SceneBatch(NamedTuple):
    frame0: torch.Tensor  # [B, S, S, 3] f32, 0..255 scale (before normalization)
    frame1: torch.Tensor  # [B, S, S, 3]
    p0: torch.Tensor  # [B, 2] target center in frame0 (x, y) px
    p1: torch.Tensor  # [B, 2] target center in frame1
    wh: torch.Tensor  # [B, 2] target box (w, h) px
    d1: torch.Tensor  # [B, 2] distractor center in frame1 (a ranked hard negative)
    look_on: torch.Tensor  # [B] 1.0 where the distractor is a lookalike clone
    frame2: torch.Tensor  # [B, S, S, 3] frame1 without the target (the occluded context)


class SceneDraws(NamedTuple):
    """Every random draw of B scene pairs, in _synth_pair's order. Uniform
    and normal draws are the values its ``jax.random`` calls return (range
    scaling included); a draw compared with a probability is kept as the
    outcome, a bool."""

    grid0: torch.Tensor  # [B, 10, 10, 3] uniform(25, 215): coarse texture octave
    grid1: torch.Tensor  # [B, 40, 40, 3] uniform(-18, 18): fine texture octave
    log_w: torch.Tensor  # [B] uniform(log 10, log 56): target width
    log_aspect: torch.Tensor  # [B] uniform(log 0.15, log 1.3)
    p0: torch.Tensor  # [B, 2] uniform(0.22 S, 0.78 S)
    delta: torch.Tensor  # [B, 2] normal: motion (x 4 px)
    colors_t: torch.Tensor  # [B, 3, 3] uniform(0, 235)
    colors_d: torch.Tensor  # [B, 3, 3] uniform(0, 235)
    d_on: torch.Tensor  # [B] bool, p 0.7: a distractor
    n_dpos: torch.Tensor  # [B, 2] normal (x 6 px)
    n_dwh: torch.Tensor  # [B, 2] normal (log size, x 0.2)
    n_drift: torch.Tensor  # [B, 2] normal (x 3 px)
    look_on: torch.Tensor  # [B] bool, p look_frac: the distractor is a lookalike
    look_r: torch.Tensor  # [B] uniform(1.3, 2.3): its distance in target widths
    look_th: torch.Tensor  # [B] uniform(0, 2 pi): its direction
    look_k5: torch.Tensor  # [B] bool, p 0.5: its spoke count is 5 (else 7)
    spokes: torch.Tensor  # [B] bool, p 0.5: the target carries spokes
    ang0: torch.Tensor  # [B] uniform(0, 2 pi): the target's angle
    u_dang: torch.Tensor  # [B] uniform(-1, 1): its rotation between frames, in bands
    wide: torch.Tensor  # [B] bool, p 0.3: the wide rotation band
    cam: torch.Tensor  # [B, 2] normal (x 2.5 px): camera shift
    n_tgain: torch.Tensor  # [B] normal (x 0.12): the target's gain in frame1
    occ_on: torch.Tensor  # [B] bool, p 0.25: an occluder
    u_occ_x: torch.Tensor  # [B] uniform(-0.8, 0.8): its offset in target widths
    occ_color: torch.Tensor  # [B, 3] uniform(40, 160)
    blur_on: torch.Tensor | None  # [B] bool, p blur_prob (None: blur_prob 0)
    blur_sigma: torch.Tensor | None  # [B] uniform(0.3, blur_sigma)
    n_gain: torch.Tensor  # [B] normal (x 0.22): global gain
    n_ch_gain: torch.Tensor  # [B, 3] normal (x 0.12): per-channel gain
    bias: torch.Tensor  # [B] uniform(-26, 26)
    noise0: torch.Tensor  # [B, S, S, 3] normal (x 3): frame0's sensor noise
    noise1: torch.Tensor  # [B, S, S, 3] normal (x 5)
    noise2: torch.Tensor  # [B, S, S, 3] normal (x 5)


def draw_scene(
    gen: torch.Generator,
    batch: int,
    size: int,
    look_frac: float = 0.35,
    blur_prob: float = 0.0,
    blur_sigma: float = 1.2,
) -> SceneDraws:
    """Every random draw of `batch` pairs of `size` px, from `gen` on its device."""
    dev = gen.device
    s = float(size)

    def uniform(shape=(), lo=0.0, hi=1.0):
        return torch.rand((batch, *shape), generator=gen, device=dev) * (hi - lo) + lo

    def normal(shape=()):
        return torch.randn((batch, *shape), generator=gen, device=dev)

    def bernoulli(p):
        return uniform() < p

    two_pi = 2.0 * math.pi
    grid0 = uniform((10, 10, 3), 25.0, 215.0)
    grid1 = uniform((40, 40, 3), -18.0, 18.0)
    log_w = uniform((), math.log(10.0), math.log(56.0))
    log_aspect = uniform((), math.log(0.15), math.log(1.3))
    p0 = uniform((2,), 0.22 * s, 0.78 * s)
    delta = normal((2,))
    colors_t = uniform((3, 3), 0.0, 235.0)
    colors_d = uniform((3, 3), 0.0, 235.0)
    d_on = bernoulli(0.7)
    n_dpos, n_dwh, n_drift = normal((2,)), normal((2,)), normal((2,))
    look_on = bernoulli(look_frac)
    look_r = uniform((), 1.3, 2.3)
    look_th = uniform((), 0.0, two_pi)
    look_k5 = bernoulli(0.5)
    spokes = bernoulli(0.5)
    ang0 = uniform((), 0.0, two_pi)
    u_dang = uniform((), -1.0, 1.0)
    wide = bernoulli(0.3)
    cam = normal((2,))
    n_tgain = normal()
    occ_on = bernoulli(0.25)
    u_occ_x = uniform((), -0.8, 0.8)
    occ_color = uniform((3,), 40.0, 160.0)
    blur_on = blur_sig = None
    if blur_prob > 0.0:
        blur_on = bernoulli(blur_prob)
        blur_sig = uniform((), 0.3, blur_sigma)
    n_gain = normal()
    n_ch_gain = normal((3,))
    bias = uniform((), -26.0, 26.0)
    noise = [normal((size, size, 3)) for _ in range(3)]
    return SceneDraws(grid0, grid1, log_w, log_aspect, p0, delta, colors_t, colors_d, d_on, n_dpos, n_dwh,
                      n_drift, look_on, look_r, look_th, look_k5, spokes, ang0, u_dang, wide, cam, n_tgain, occ_on,
                      u_occ_x, occ_color, blur_on, blur_sig, n_gain, n_ch_gain, bias, *noise)


def _octave(grid: torch.Tensor, size: int) -> torch.Tensor:
    """A random texture grid [B, c, c, 3] upsampled to [B, S, S, 3]:
    half-pixel bilinear with the edge held, which is what
    ``jax.image.resize(..., "linear")`` gives when it upsamples."""
    x = F.interpolate(grid.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.permute(0, 2, 3, 1)


def _col(x, like: torch.Tensor) -> torch.Tensor:
    """A per-sample value ([B] tensor or a float) shaped [B, 1, 1] against `like`."""
    if not isinstance(x, torch.Tensor):
        x = torch.full(like.shape[:1], float(x), dtype=torch.float32, device=like.device)
    return x[:, None, None]


def _paint_blob(
    frame: torch.Tensor,  # [B, S, S, 3]
    p: torch.Tensor,  # [B, 2] center (x, y)
    wh: torch.Tensor,  # [B, 2] (w, h)
    colors: torch.Tensor,  # [B, 3, 3] rows: core / rim / base per-channel weights
    gain,  # [B] or float: intensity gain
    enable,  # [B] or float: 0/1, so a sample can omit the blob
    angle=0.0,  # [B] or float: in-plane rotation (radians)
    spokes=0.0,  # [B] or float: azimuthal harmonic amplitude
    spoke_k=3.0,  # [B] or float: azimuthal harmonic count
) -> torch.Tensor:
    """Composite a soft-edged textured rectangle (a radial core and rim, and
    an optional azimuthal "spoke" harmonic that gives the pattern an
    orientation) into each sample's frame."""
    s = frame.shape[-2]
    r_ = torch.arange(s, dtype=torch.float32, device=frame.device)
    yy, xx = r_[:, None], r_[None, :]
    angle = _col(angle, frame)
    ca, sa = torch.cos(angle), torch.sin(angle)
    ux = xx - p[:, 0, None, None]
    uy = yy - p[:, 1, None, None]
    hw, hh = (wh[:, 0] / 2.0)[:, None, None], (wh[:, 1] / 2.0)[:, None, None]
    rx = (ca * ux + sa * uy) / hw
    ry = (-sa * ux + ca * uy) / hh
    r = torch.sqrt(rx * rx + ry * ry)
    core = torch.clamp(1.0 - r, 0.0, 1.0)
    rim = torch.clamp(r - 0.3, 0.0, 1.0)
    phi = torch.atan2(ry, rx)
    core = torch.clamp(core * (1.0 + _col(spokes, frame) * torch.cos(_col(spoke_k, frame) * phi)), 0.0, 1.0)
    # A soft edge of about a pixel: alpha ramps with the distance to the box border.
    dist_px = torch.minimum((1.0 - torch.abs(rx)) * hw, (1.0 - torch.abs(ry)) * hh)
    alpha = torch.clamp(dist_px + 0.5, 0.0, 1.0) * _col(enable, frame)
    tex = (core[..., None] * colors[:, None, None, 0] + rim[..., None] * colors[:, None, None, 1]
           + colors[:, None, None, 2]) * _col(gain, frame)[..., None]
    return frame * (1.0 - alpha[..., None]) + tex * alpha[..., None]


def _sep_blur(img: torch.Tensor, sigma: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """7-tap separable Gaussian blur of [B, S, S, 3] with the edge held, one
    sigma [B] a sample, applied where on [B] > 0: what a video codec does to
    fine pattern detail (the spoke harmonics that tell lookalike clones
    apart)."""
    t = torch.arange(-3, 4, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * torch.square(t / torch.clamp(sigma, min=1e-3)[:, None]))
    k = k / torch.sum(k, dim=-1, keepdim=True)

    def blur1d(x, axis):
        n = x.shape[axis]
        idx = torch.clamp(torch.arange(-3, n + 3, device=x.device), 0, n - 1)
        xp = x.index_select(axis, idx)
        out = torch.zeros_like(x)
        for i in range(7):
            out = out + k[:, i, None, None, None] * xp.narrow(axis, i, n)
        return out

    blurred = blur1d(blur1d(img, 1), 2)
    return torch.where(on[:, None, None, None] > 0, blurred, img)


def render_scene(d: SceneDraws, size: int, blur_prob: float = 0.0) -> SceneBatch:
    """The B scene pairs of these draws (deterministic)."""
    s = float(size)
    f32 = torch.float32
    bg = _octave(d.grid0, size) + _octave(d.grid1, size)

    # Target geometry: log-uniform width; aspect from needle-like to square-ish.
    tw = torch.exp(d.log_w)
    th = torch.clamp(tw * torch.exp(d.log_aspect), 5.0, 56.0)
    wh = torch.stack([tw, th], dim=-1)
    p0 = d.p0
    p1 = torch.clamp(p0 + 4.0 * d.delta, 0.18 * s, 0.82 * s)

    # The distractor (p 0.7), opposite the target's half of the frame.
    d_on = d.d_on.to(f32)
    d_pos = torch.where(p0 < s / 2, 0.75 * s, 0.25 * s) + 6.0 * d.n_dpos
    d_wh = wh * torch.exp(0.2 * d.n_dwh)
    d_drift = 3.0 * d.n_drift

    # Lookalike mode: the distractor clones the target's colors and size,
    # differs only in its spoke count (5 or 7 against 3), and sits inside
    # the search window 1.3-2.3 target widths from the true box.
    look_on = d.look_on.to(f32)
    look = d.look_on
    look_r = torch.amax(wh, dim=-1) * d.look_r
    look_pos = torch.clamp(p1 + look_r[:, None] * torch.stack([torch.cos(d.look_th), torch.sin(d.look_th)], -1),
                           0.08 * s, 0.92 * s)
    d_on = torch.maximum(d_on, look_on)
    colors_d = torch.where(look[:, None, None], d.colors_t, d.colors_d)
    d_wh = torch.where(look[:, None], wh, d_wh)
    d_pos = torch.where(look[:, None], look_pos, d_pos)
    d_drift = torch.where(look[:, None], torch.zeros_like(d_drift), d_drift)
    d_spoke_k = torch.where(look, torch.where(d.look_k5, 5.0, 7.0), 3.0)
    d_spokes = torch.where(look, 0.6, 0.0)

    # Orientation: spokes on half the samples (on every lookalike one), and a
    # rotation between the frames, 70 % in a mild band and 30 % in a wide one.
    spoke_amp = torch.where(d.spokes | look, 0.6, 0.0)
    d_ang = torch.where(d.wide, 0.45, 0.15) * d.u_dang

    def compose(bg_img, tp, dp, tgain, ang):
        f = _paint_blob(bg_img, dp, d_wh, colors_d, 1.0, d_on, spokes=d_spokes, spoke_k=d_spoke_k)
        return _paint_blob(f, tp, wh, d.colors_t, tgain, 1.0, angle=ang, spokes=spoke_amp)

    frame0 = compose(bg, p0, d_pos, 1.0, d.ang0)

    # frame1: camera shift, the target's gain, the distractor's drift.
    d1 = d_pos + d_drift
    ctr = s / 2 + 2.5 * d.cam
    bg1 = extract_window_mxu(bg, ctr, torch.full((), s, dtype=f32, device=bg.device), size)
    frame1 = compose(bg1, p1, d1, torch.exp(0.12 * d.n_tgain), d.ang0 + d_ang)
    # frame2: the same scene with the target absent; only the distractor.
    frame2 = _paint_blob(bg1, d1, d_wh, colors_d, 1.0, d_on, spokes=d_spokes, spoke_k=d_spoke_k)

    # A vertical occluder band over the target in frame1 (p 0.25).
    occ_x = p1[:, 0] + d.u_occ_x * tw
    occ_w = torch.clamp(0.5 * tw, 3.0, 20.0)
    xs = torch.arange(size, dtype=f32, device=bg.device)
    occ = (torch.abs(xs - occ_x[:, None]) < (occ_w / 2)[:, None]).to(f32) * d.occ_on.to(f32)[:, None]
    occ = occ[:, None, :, None]
    frame1 = frame1 * (1.0 - occ) + d.occ_color[:, None, None, :] * occ

    # Codec-like low-pass, one sigma a pair, on all three views, before the noise.
    if blur_prob > 0.0:
        on = d.blur_on.to(f32)
        frame0 = _sep_blur(frame0, d.blur_sigma, on)
        frame1 = _sep_blur(frame1, d.blur_sigma, on)
        frame2 = _sep_blur(frame2, d.blur_sigma, on)

    # Photometric jitter on frame1 and frame2 (the same scene), sensor noise on all.
    gc = (torch.exp(0.22 * d.n_gain)[:, None] * torch.exp(0.12 * d.n_ch_gain))[:, None, None, :]
    bias = d.bias[:, None, None, None]
    frame0 = frame0 + 3.0 * d.noise0
    frame1 = frame1 * gc + bias + 5.0 * d.noise1
    frame2 = frame2 * gc + bias + 5.0 * d.noise2
    return SceneBatch(
        frame0=torch.clamp(frame0, 0.0, 255.0),
        frame1=torch.clamp(frame1, 0.0, 255.0),
        p0=p0,
        p1=p1,
        wh=wh,
        d1=d1,
        look_on=look_on,
        frame2=torch.clamp(frame2, 0.0, 255.0),
    )


def make_pair_batch(
    gen: torch.Generator,
    batch: int,
    size: int,
    look_frac: float = 0.35,
    blur_prob: float = 0.0,
    blur_sigma: float = 1.2,
) -> SceneBatch:
    """B scene pairs of `size` px drawn from `gen`, on its device.

    look_frac (train.lookalike_frac): the fraction of pairs whose distractor
    is a lookalike clone. blur_prob / blur_sigma (train.blur_*): the
    codec-like low-pass augmentation (_sep_blur)."""
    return render_scene(draw_scene(gen, batch, size, look_frac, blur_prob, blur_sigma), size, blur_prob)
