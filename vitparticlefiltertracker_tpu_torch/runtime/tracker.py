"""Tracker orchestration: init(frame, bbox) / step(frame) — the port of the
JAX package's ``runtime/tracker.py``.

A dense-mode step: propagate -> window extraction -> one ViT forward ->
fused per-cell cosine scoring -> masked z-norm -> pf_update -> template EMA
with anchor mix -> lost and coast bookkeeping. A crop-mode step samples one
crop per particle instead (``tracker.crop_impl``: from the frame, or from one
resampled search window through the plain version or kernel K2), embeds all
N crops in one ViT forward with position embeddings, mean-pools them and
scores each against the template. The JAX version is one jitted program
with ``lax.cond`` for its two lost-only branches; here PyTorch runs eagerly
and each is a host branch: the probe (dense mode only) on the lost flag, the
global re-detection scan on lost_count reaching redetect_global_after.

Ported: dense and crop mode with the lost gate and probe, template EMA and
anchor, coasting, the residual head's blend (static, or automatic for the
likelihood), global re-detection (the tiled scan in dense mode, one flat
grid of crops in crop mode) with its reseed, the Tracker class and the
name-keyed state npz shared with the JAX package.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.filters.particle import (
    MotionParams,
    PFParams,
    PFState,
    StepNoise,
    draw_reseed_noise,
    draw_step_noise,
    init_state,
    pf_update,
    propagate,
)
from vitparticlefiltertracker_tpu_torch.models.embedder import (
    DenseEmbedSpec,
    make_dense_embedder,
    tiled_window_embed,
)
from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec, encode_tokens, pool_tokens
from vitparticlefiltertracker_tpu_torch.ops.image import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    FrameView,
    frame_to_window_coords,
    full_view,
    view_extract_window_mxu,
)
from vitparticlefiltertracker_tpu_torch.ops.likelihood import (
    auto_blend_target,
    cosine_log_likelihood,
    l2_normalize_split,
    landscape_spread,
    znormed_log_likelihood,
    znormed_logits_from_cos,
)
from vitparticlefiltertracker_tpu_torch.ops.patchify import gather_patchify
from vitparticlefiltertracker_tpu_torch.ops.patchify_window import (
    window_gather_patchify,
    window_gather_patchify_plain,
)
from vitparticlefiltertracker_tpu_torch.utils.platform import resolve_device


class TrackerState(NamedTuple):
    """Tracker state; every leaf is a tensor on the tracker's device."""

    pf: PFState
    template: torch.Tensor  # [C, D] f32, L2-normalized adaptive template (EMA)
    anchor: torch.Tensor  # [C, D] f32, immutable first-frame template
    box_wh: torch.Tensor  # [2] f32 base box (w, h) at log_s = 0
    center: torch.Tensor  # [2] f32 search-window center (previous estimate)
    prev_scale: torch.Tensor  # [] f32 last estimated scale factor
    key: torch.Tensor  # [2] int64 (hi, lo) words of the seed; noise is keyed
    # on (seed, frame_idx). Same layout as the JAX key data, not the same stream.
    frame_idx: torch.Tensor  # [] int32
    conf: torch.Tensor  # [] f32 last appearance confidence
    lost: torch.Tensor  # [] bool
    lost_count: torch.Tensor  # [] int32 consecutive lost frames
    conf_ema: torch.Tensor  # [] f32 locked-state confidence EMA (-1 = unseeded)
    coast_xy: torch.Tensor  # [2] f32 last-locked position, advanced while lost
    coast_vel: torch.Tensor  # [2] f32 last-locked velocity
    coast_acc: torch.Tensor  # [2] f32 EMA of locked per-frame velocity deltas
    blend: torch.Tensor  # [] f32 running likelihood head blend of the automatic
    # policy (-1 = unseeded; inert when model.head_blend_auto is off)


class TrackOutput(NamedTuple):
    position: torch.Tensor  # [2] (x, y)
    box: torch.Tensor  # [2] (w, h)
    velocity: torch.Tensor  # [2]
    conf: torch.Tensor  # []
    ess: torch.Tensor  # []
    resampled: torch.Tensor  # [] bool
    lost: torch.Tensor  # [] bool


def pack_track_output(out: TrackOutput) -> torch.Tensor:
    """Flatten a TrackOutput into one f32 vector, field order, each raveled."""
    return torch.cat([x.reshape(-1).to(torch.float32) for x in out])


def _pf_params(cfg: Config) -> PFParams:
    f = cfg.filter
    return PFParams(
        motion=MotionParams(
            sigma_pos=f.motion.sigma_pos,
            sigma_vel=f.motion.sigma_vel,
            sigma_scale=f.motion.sigma_scale,
            vel_decay=f.motion.vel_decay,
        ),
        ess_threshold=f.ess_threshold,
        init_sigma_pos=f.init_sigma_pos,
        init_sigma_vel=f.init_sigma_vel,
    )


def _window_side(box_wh: torch.Tensor, scale, search_scale: float) -> torch.Tensor:
    return search_scale * torch.sqrt(box_wh[0] * box_wh[1]) * scale


def _norm_folded_embed_weights(prm: dict, spec: VitSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold pixel normalization into the patch-embed affine map:
    ((x - m)/s) @ K = x @ (K / s_per_channel) - ((m/s) @ K). Crop mode samples
    raw frames with it; the dense path normalizes the window instead."""
    kern_f = prm["patch_embed"]["kernel"].float()  # [p*p*3, D]
    dev = kern_f.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev) * 255.0
    k3 = kern_f.reshape(-1, 3, spec.dim)
    kern_scaled = (k3 / std[None, :, None]).reshape(-1, spec.dim)
    bias_shift = torch.einsum("pcd,c->d", k3, mean / std)
    bias = prm["patch_embed"]["bias"].float() - bias_shift
    return kern_scaled.to(spec.dtype), bias.to(spec.dtype)


def seed_key(seed: int, device) -> torch.Tensor:
    """[2] int64 (hi, lo) 32-bit words of a seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & 0xFFFFFFFF], dtype=torch.int64, device=device)


def key_seed(key: torch.Tensor) -> int:
    hi, lo = (int(x) for x in key.tolist())
    return (hi << 32) | lo


class _Fns(NamedTuple):
    init: Callable
    step: Callable


def build_tracker_fns(cfg: Config) -> _Fns:
    """Build (init_fn, step_fn) for a dense- or crop-mode config.

    init(params, frame, bbox, seed, cloud=None) -> TrackerState
    step(params, state, frame, noise=None, reseed=None) -> (TrackerState, TrackOutput)

    frame: [H, W, 3] tensor (uint8 or float, 0..255) on the run's device.
    cloud / noise / reseed: optional injected initial particles, step draws
    and [N, 2] re-detection reseed normals (parity runs); by default they are
    drawn from generators keyed on (seed, frame).
    """
    t = cfg.tracker
    m = cfg.model
    mode = t.mode
    if mode == "crop":
        # Each crop is its own image of crop_size px, position embeddings on
        # (the first g*g rows of pos_embed).
        spec = VitSpec.from_config(m)._replace(image_size=t.crop_size)
        split = None
    else:
        es = DenseEmbedSpec.from_config(cfg)
        split = es.split
    pfp = _pf_params(cfg)
    n = cfg.filter.num_particles
    temp = cfg.filter.likelihood_temp
    zscale = cfg.filter.likelihood_zscale
    use_znorm = cfg.filter.likelihood == "zcos"
    lost_thresh = cfg.filter.lost_conf_threshold
    lost_ratio = cfg.filter.lost_conf_ratio
    relock_ratio = t.relock_conf_ratio
    ema = t.template_ema
    upd_conf = t.template_update_conf
    anchor_mix = t.template_anchor_mix
    # Automatic head blend (model.head_blend_auto): the likelihood blends the
    # halves at a per-step weight; the gates, the probe and re-detection keep
    # the static head_blend (through `split`).
    auto_blend = bool(m.head_blend_auto) and split is not None
    ab_init = float(min(max(m.head_blend, m.head_blend_min), m.head_blend_max))

    def f32(x, dev):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def crop_embeddings(prm, view: FrameView, center, side, boxes_xy, boxes_wh):
        """Gather + patchify + embed every box's crop, then one batched ViT
        forward -> ([N, D] pooled embeddings, [N] all-True validity)."""
        kern, bias = _norm_folded_embed_weights(prm, spec)
        if t.crop_impl == "frame":
            # Sample in the view's pixel coordinates.
            inv = 1.0 / float(view.stride)
            tokens = gather_patchify(
                view.pixels, (boxes_xy - view.origin) * inv, boxes_wh * inv,
                t.crop_size, m.patch_size, kern, bias, region=t.crop_region,
            )
        else:
            # Two stages: resample one search window, then every particle's
            # crop from it (K2 on the card for window-pallas).
            swin = t.window_size
            window = view_extract_window_mxu(view, center, side, swin)
            ctr_win = frame_to_window_coords(boxes_xy, center, side, swin)
            wh_win = boxes_wh * (swin / side)
            embed = window_gather_patchify if t.crop_impl == "window-pallas" else window_gather_patchify_plain
            tokens = embed(window, ctr_win, wh_win, t.crop_size, m.patch_size, kern, bias)
        feats = encode_tokens(prm, tokens, spec)
        ok = torch.ones(boxes_xy.shape[0], dtype=torch.bool, device=boxes_xy.device)
        return pool_tokens(feats, spec), ok

    def make_embedder(prm, view: FrameView, center, side):
        if mode == "dense":
            return make_dense_embedder(prm, view, center, side, es)
        return lambda bxy, bwh: crop_embeddings(prm, view, center, side, bxy, bwh)

    def init_fn(prm, frame, bbox: torch.Tensor, seed: int, cloud=None) -> TrackerState:
        """bbox: [4] (x, y, w, h) frame px. Template and cloud init."""
        dev = bbox.device
        view = full_view(frame.to(torch.float32))
        center = bbox[:2] + bbox[2:] / 2.0
        box_wh = bbox[2:]
        side = _window_side(box_wh, 1.0, t.search_scale)
        emb, _ = make_embedder(prm, view, center, side)(center[None], box_wh[None])
        template = l2_normalize_split(emb[0].float(), split)
        pf = init_state(seed, center, n, pfp, cloud=cloud)
        return TrackerState(
            pf=pf,
            template=template,
            anchor=template,
            box_wh=box_wh,
            center=center,
            prev_scale=f32(1.0, dev),
            key=seed_key(seed, dev),
            frame_idx=torch.tensor(0, dtype=torch.int32, device=dev),
            conf=f32(1.0, dev),
            lost=torch.tensor(False, device=dev),
            lost_count=torch.tensor(0, dtype=torch.int32, device=dev),
            conf_ema=f32(-1.0, dev),
            coast_xy=center,
            coast_vel=torch.zeros(2, dtype=torch.float32, device=dev),
            coast_acc=torch.zeros(2, dtype=torch.float32, device=dev),
            blend=f32(-1.0, dev),
        )

    n_after = t.redetect_global_after
    g = t.redetect_global_grid
    c_sub = 3  # candidate sub-grid per tile (dense tiled scan)

    def global_scan(prm, view: FrameView, tmpl, side, cand_wh):
        """Score a grid of candidate boxes of size cand_wh over the whole frame
        against the template -> (best_xy [2], best_cos [], best_z []), z being
        the winner's margin over the valid candidates in standard deviations.

        Dense mode tiles the frame with G*G windows at about the local
        search's scale (one batched ViT forward) and C*C candidates a tile;
        crop mode embeds the G*G tile centres as crops of one whole-frame
        window. A function of tensors only, so a captured step can hold it."""
        dev = cand_wh.device
        h_px, w_px = int(view.pixels.shape[0]), int(view.pixels.shape[1])
        gxs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * (w_px / g)
        gys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * (h_px / g)
        tile_ctrs = torch.stack([gxs.repeat(g), gys.repeat_interleave(g)], dim=-1)  # [G*G, 2], row-major
        frame_side = f32(max(h_px, w_px), dev)
        if mode == "dense":
            tile_side = torch.maximum(1.25 * frame_side / g, side)
            oxs = (torch.arange(c_sub, dtype=torch.float32, device=dev) - (c_sub - 1) / 2) * (w_px / (g * c_sub))
            oys = (torch.arange(c_sub, dtype=torch.float32, device=dev) - (c_sub - 1) / 2) * (h_px / (g * c_sub))
            offs = torch.stack([oxs.repeat(c_sub), oys.repeat_interleave(c_sub)], dim=-1)  # [C*C, 2]
            cand = tile_ctrs[:, None, :] + offs[None, :, :]  # [G*G, C*C, 2]
            emb, valid = tiled_window_embed(prm, view, tile_ctrs, tile_side, es, cand, cand_wh)
            emb = emb.reshape(g * g * c_sub * c_sub, *emb.shape[2:])
            valid = valid.reshape(-1)
            cand = cand.reshape(-1, 2)
        else:
            cand = tile_ctrs
            center = torch.tensor([w_px / 2.0, h_px / 2.0], dtype=torch.float32, device=dev)
            emb, valid = crop_embeddings(prm, view, center, frame_side, cand, cand_wh.expand(cand.shape))
        _, cos = cosine_log_likelihood(emb, tmpl, 1.0, split=split)
        cos = torch.where(valid, cos, f32(-2.0, dev))
        b = torch.argmax(cos)
        nv = torch.clamp(valid.sum(), min=1)
        mu = torch.sum(torch.where(valid, cos, f32(0.0, dev))) / nv
        var = torch.sum(torch.where(valid, (cos - mu) ** 2, f32(0.0, dev))) / nv
        z = (cos[b] - mu) * torch.rsqrt(var + 1e-8)
        return cand[b], cos[b], z

    def step_fn(prm, state: TrackerState, frame, noise: StepNoise | None = None,
                reseed: torch.Tensor | None = None):
        dev = state.center.device
        view = full_view(frame.to(torch.float32))
        fh, fw = int(frame.shape[0]), int(frame.shape[1])
        if noise is None:
            noise = draw_step_noise(key_seed(state.key), int(state.frame_idx), n, dev)
        # While lost, sweep a wider area: inflate position diffusion and the
        # search window until re-lock.
        noise_boost = torch.where(state.lost, f32(t.redetect_noise_boost, dev), f32(1.0, dev))
        noise = noise._replace(pos=noise.pos * noise_boost)
        particles = propagate(state.pf.particles, noise, pfp.motion)

        side = _window_side(state.box_wh, state.prev_scale, t.search_scale)
        side = side * torch.where(state.lost, f32(t.redetect_window_boost, dev), f32(1.0, dev))
        boxes_xy = particles[:, 0:2]
        boxes_wh = state.box_wh[None, :] * torch.exp(particles[:, 4:5])
        pool = make_embedder(prm, view, state.center, side)
        # Matching template: adaptive EMA blended with the immutable anchor.
        if anchor_mix > 0.0 and ema > 0.0:
            tmpl = l2_normalize_split(
                anchor_mix * state.anchor + (1.0 - anchor_mix) * state.template, split
            )
        else:
            tmpl = state.template
        if auto_blend:
            # Two blends from one scoring pass: the gates' cosine at the
            # static blend, the likelihood's at max(running, target) (fast
            # attack), or the static one while lost.
            cos_f, cos_h, in_win = pool.score_halves(tmpl, boxes_xy, boxes_wh)
            b_run = torch.where(state.blend >= 0.0, state.blend, f32(ab_init, dev))
            b_static = split[1]
            cos = (1.0 - b_static) * cos_f + b_static * cos_h
            # Confusion: the spatial spread of the trunk landscape's top slice,
            # in box diagonals.
            spread = landscape_spread(cos_f, boxes_xy, m.head_blend_top_frac, mask=in_win)
            box_diag = torch.linalg.vector_norm(state.box_wh) * state.prev_scale
            b_tgt = auto_blend_target(spread, box_diag, m.head_blend_spread_lo, m.head_blend_spread_hi,
                                      m.head_blend_min, m.head_blend_max)
            b_use = torch.where(state.lost, f32(b_static, dev), torch.maximum(b_run, b_tgt))
            cos_loc = (1.0 - b_use) * cos_f + b_use * cos_h
            loglik = znormed_logits_from_cos(cos_loc, zscale, mask=in_win) if use_znorm else temp * cos_loc
        elif mode == "dense":
            cos, in_win = pool.score(tmpl, boxes_xy, boxes_wh)
            if use_znorm:
                # Masked stats: out-of-window particles' clamped-edge cosines
                # must not skew mu/sd.
                loglik = znormed_logits_from_cos(cos, zscale, mask=in_win)
            else:
                loglik = temp * cos
        else:
            emb, in_win = pool(boxes_xy, boxes_wh)
            if use_znorm:
                loglik, cos = znormed_log_likelihood(emb, tmpl, zscale, mask=in_win, split=split)
            else:
                loglik, cos = cosine_log_likelihood(emb, tmpl, temp, split=split)
        loglik = torch.where(in_win, loglik, loglik - 1e4)

        out = pf_update(particles, state.pf.log_weights, loglik, noise.resample_u, pfp)
        if t.estimate == "mode":
            est = particles[torch.argmax(state.pf.log_weights + loglik)]
        else:
            est = out.estimate
        est_xy = est[0:2]
        est_scale = torch.exp(est[4])
        # Confidence = best valid cosine; all-out-of-window gives -1.
        conf = torch.max(torch.where(in_win, cos, f32(-1.0, dev)))
        if mode == "dense" and (lost_thresh > 0.0 or lost_ratio > 0.0) and bool(state.lost):
            # While lost the window is boosted, which depresses every cosine;
            # probe the estimate through an unboosted window instead (one
            # extra ViT forward, on lost frames only). Crop mode embeds at
            # the box's own scale already and has no probe.
            side0 = _window_side(state.box_wh, state.prev_scale, t.search_scale)
            pool_p = make_dense_embedder(prm, view, est_xy, side0, es)
            emb_p, ok_p = pool_p(est_xy[None], (state.box_wh * est_scale)[None])
            _, cos_p = cosine_log_likelihood(emb_p, tmpl, 1.0, split=split)
            conf_gate = torch.where(ok_p[0], cos_p[0], f32(-1.0, dev))
        else:
            conf_gate = conf
        lost = conf_gate < lost_thresh
        unseeded = state.conf_ema < 0.0
        conf_base = torch.where(unseeded, conf_gate, state.conf_ema)
        if lost_ratio > 0.0:
            lost = lost | (conf_gate < lost_ratio * conf_base)
        if relock_ratio > 0.0:
            lost = lost | (state.lost & (conf_gate < relock_ratio * conf_base))
        # The EMA adopts the first non-lost confidence and is frozen while lost.
        conf_ema_new = torch.where(
            lost,
            torch.where(unseeded, state.conf_ema, conf_base),
            0.9 * conf_base + 0.1 * conf_gate,
        )

        # Template EMA at the estimated box, gated on confidence.
        if ema > 0.0:
            est_emb, _ = pool(est_xy[None], (state.box_wh * est_scale)[None])
            cand = l2_normalize_split(
                (1.0 - ema) * state.template
                + ema * l2_normalize_split(est_emb[0].float(), split),
                split,
            )
            do_upd = (conf > upd_conf) & ~lost & ~state.lost
            template = torch.where(do_upd, cand, state.template)
        else:
            template = state.template

        # When lost, freeze the search window instead of chasing noise.
        new_center = torch.where(lost, state.center, est_xy)
        lost_count = torch.where(lost, state.lost_count + 1, torch.zeros_like(state.lost_count))
        new_pf = out.state
        scale_frozen = lost  # prev_scale keeps the pre-reseed lost flag
        accepted = torch.zeros_like(lost)
        est_out = est_xy

        # Global re-detection: after redetect_global_after lost frames in a
        # row, scan a grid over the whole frame against the template and, on
        # an accepted match, reseed the cloud there (a host branch where the
        # JAX package has lax.cond).
        if n_after > 0 and bool(lost_count >= n_after):
            cand_wh = state.box_wh * state.prev_scale
            best_xy, best_cos, best_z = global_scan(prm, view, tmpl, side, cand_wh)
            accept = (best_cos >= t.redetect_accept_conf) & (best_z >= t.redetect_accept_z)
            if t.redetect_accept_ratio > 0:
                # A fraction of the locked-state confidence EMA, skipped while
                # unseeded.
                accept = accept & ((state.conf_ema <= 0) | (best_cos >= t.redetect_accept_ratio * state.conf_ema))
            if reseed is None:
                reseed = draw_reseed_noise(key_seed(state.key), int(state.frame_idx), n, dev)
            # A fresh cloud spread over the winning grid cell, zero velocity,
            # uniform weights.
            cell_sigma = torch.tensor([fw / g, fh / g], dtype=torch.float32, device=dev) / 4.0
            reseeded = torch.cat([best_xy[None, :] + cell_sigma * reseed,
                                  torch.zeros((n, 2), dtype=torch.float32, device=dev),
                                  new_pf.particles[:, 4:]], dim=1)
            uniform_w = torch.full((n,), -math.log(n), dtype=torch.float32, device=dev)
            new_pf = PFState(particles=torch.where(accept, reseeded, new_pf.particles),
                             log_weights=torch.where(accept, uniform_w, new_pf.log_weights))
            new_center = torch.where(accept, best_xy, new_center)
            lost_count = torch.where(accept, torch.zeros_like(lost_count), lost_count)
            # An accepted match is the re-acquisition and clears `lost`, unless
            # re-lock hysteresis is on: then the next step's unboosted probe
            # must clear relock_conf_ratio first.
            if relock_ratio <= 0.0:
                lost = lost & ~accept
            accepted = accept
            est_out = torch.where(accept, best_xy, est_xy)

        # Lost-aware output: while lost the reported trajectory coasts on the
        # last-locked position and velocity (plus the clipped acceleration
        # EMA), clamped to the frame; the filter itself is untouched. An
        # accepted global match snaps the output to the match and resets the
        # coast.
        frame_max = torch.tensor([fw - 1, fh - 1], dtype=torch.float32, device=dev)
        est_vel = est[2:4]
        zero2 = torch.zeros_like(est_vel)
        a_ema = t.coast_accel_ema
        acc_upd = torch.clamp(
            (1.0 - a_ema) * state.coast_acc + a_ema * (est_vel - state.coast_vel),
            -t.coast_accel_clip,
            t.coast_accel_clip,
        )
        coast_acc = torch.where(lost, state.coast_acc, torch.where(accepted, zero2, acc_upd))
        vel_lost = state.coast_vel + state.coast_acc
        coast_xy = torch.where(
            lost, torch.clamp(state.coast_xy + vel_lost, min=torch.zeros_like(frame_max), max=frame_max), est_out
        )
        coast_vel = torch.where(lost, vel_lost, torch.where(accepted, zero2, est_vel))
        if auto_blend:
            # Frozen while lost; otherwise attack at once and release along
            # the EMA.
            blend_next = torch.where(
                lost, b_run, torch.maximum((1.0 - m.head_blend_ema) * b_run + m.head_blend_ema * b_tgt, b_tgt)
            )
        else:
            blend_next = state.blend
        new_state = TrackerState(
            pf=new_pf,
            template=template,
            anchor=state.anchor,
            box_wh=state.box_wh,
            center=new_center,
            prev_scale=torch.where(scale_frozen, state.prev_scale, est_scale),
            key=state.key,
            frame_idx=state.frame_idx + 1,
            conf=conf_gate,
            lost=lost,
            lost_count=lost_count,
            conf_ema=conf_ema_new,
            coast_xy=coast_xy,
            coast_vel=coast_vel,
            coast_acc=coast_acc,
            blend=blend_next,
        )
        track_out = TrackOutput(
            position=coast_xy,
            box=state.box_wh * torch.where(lost, state.prev_scale, est_scale),
            velocity=coast_vel,
            conf=conf_gate,
            ess=out.ess,
            resampled=out.resampled,
            lost=lost,
        )
        return new_state, track_out

    return _Fns(init=init_fn, step=step_fn)


# ---------------------------------------------------------------------------
# State checkpoint/resume: the JAX package's name-keyed npz (format v1), so a
# state saved by either package loads in the other. The `key` leaf carries
# each package's own RNG key, so the noise stream does not carry across.
# ---------------------------------------------------------------------------

STATE_FORMAT_VERSION = 1
_STATE_FORMAT_KEY = "__vpt_state_format__"
_NP_DTYPES = {"key": np.uint32, "frame_idx": np.int32, "lost_count": np.int32, "lost": np.bool_}


def _named_state_leaves(state: TrackerState) -> dict[str, torch.Tensor]:
    """Flatten nested NamedTuples to {"pf/particles": tensor, ...}."""
    out = {}
    for k, v in state._asdict().items():
        if isinstance(v, PFState):
            for k2, v2 in v._asdict().items():
                out[f"{k}/{k2}"] = v2
        else:
            out[k] = v
    return out


def save_tracker_state(path: str, state: TrackerState) -> None:
    flat = {
        k: v.detach().cpu().numpy().astype(_NP_DTYPES.get(k, np.float32))
        for k, v in _named_state_leaves(state).items()
    }
    flat[_STATE_FORMAT_KEY] = np.asarray(STATE_FORMAT_VERSION)
    np.savez(path, **flat)


# Round-1 files carry no format marker: leaf_<i> in this field order (the JAX
# package's _state_from_positional); the oldest lack the anchor (index 3).
_POSITIONAL_STATE_NAMES = (
    "pf/particles", "pf/log_weights", "template", "anchor", "box_wh",
    "center", "prev_scale", "key", "frame_idx", "conf", "lost",
)


def _named_from_positional(flat: dict, path: str) -> dict:
    try:
        leaves = [flat[f"leaf_{i}"] for i in range(len(flat))]
    except KeyError:
        raise ValueError(f"{path}: not a TrackerState checkpoint") from None
    names = _POSITIONAL_STATE_NAMES
    if len(leaves) == len(names) - 1:
        leaves.insert(3, leaves[2])  # pre-anchor file: anchor := template
    if len(leaves) != len(names):
        raise ValueError(f"{path}: {len(leaves)} leaves, expected {len(names)} — not a "
                         "TrackerState checkpoint (or from an incompatible version)")
    return dict(zip(names, leaves))


def load_tracker_state(path: str, device="cpu") -> TrackerState:
    """Read a state saved by either package: the name-keyed v1 format, or a
    round-1 positional file."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    if _STATE_FORMAT_KEY in flat:
        version = int(flat.pop(_STATE_FORMAT_KEY))
        if version > STATE_FORMAT_VERSION:
            raise ValueError(
                f"{path}: state format v{version}, this build reads up to v{STATE_FORMAT_VERSION}"
            )
    else:
        flat = _named_from_positional(flat, path)

    def get(name, default=None):
        if name in flat:
            arr = flat[name]
        elif default is not None:
            arr = default
        else:
            raise ValueError(f"{path}: missing state entry '{name}'")
        arr = np.array(arr, dtype=np.int64 if name == "key" else None)  # 0-d stays 0-d
        return torch.from_numpy(arr).to(device)

    conf = np.asarray(flat["conf"], np.float32)
    center = np.asarray(flat["center"], np.float32)
    return TrackerState(
        pf=PFState(particles=get("pf/particles"), log_weights=get("pf/log_weights")),
        template=get("template"),
        anchor=get("anchor", flat.get("template")),
        box_wh=get("box_wh"),
        center=get("center"),
        prev_scale=get("prev_scale"),
        key=get("key"),
        frame_idx=get("frame_idx"),
        conf=get("conf"),
        lost=get("lost"),
        lost_count=get("lost_count", np.zeros_like(flat["frame_idx"], np.int32)),
        conf_ema=get("conf_ema", np.full_like(conf, -1.0)),
        coast_xy=get("coast_xy", center),
        coast_vel=get("coast_vel", np.zeros_like(center)),
        coast_acc=get("coast_acc", np.zeros_like(center)),
        blend=get("blend", np.full_like(conf, -1.0)),
    )


class Tracker:
    """User-facing API: Tracker(cfg).init(frame, bbox); .step(frame); .run(source).

    device: "cuda" (default) or "cpu". Asking for CUDA without a card raises.
    """

    def __init__(self, cfg: Config, vit_params=None, device="cuda"):
        from vitparticlefiltertracker_tpu_torch.models.params import resolve_vit_params

        cfg.resolve()
        r = cfg.runtime
        if r.banks > 1:
            raise NotImplementedError("runtime.banks > 1 (banked trackers) is not ported yet; see ROADMAP.md")
        if r.mesh_particles * r.mesh_model > 1:
            raise NotImplementedError(
                f"runtime.mesh_particles {r.mesh_particles} x mesh_model {r.mesh_model} (multi-GPU) "
                "is not ported yet; see ROADMAP.md, open items §1 item 10"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        spec = VitSpec.from_config(cfg.model)
        if cfg.tracker.mode == "crop":
            spec = spec._replace(image_size=cfg.tracker.crop_size)
        self.spec = spec
        self._fns = build_tracker_fns(cfg)
        self.vit_params = resolve_vit_params(cfg, vit_params, self.device)
        self.state: TrackerState | None = None

    def _frame(self, frame) -> torch.Tensor:
        if isinstance(frame, torch.Tensor):
            return frame.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)

    def init(self, frame, bbox) -> None:
        bbox_t = torch.as_tensor(np.asarray(bbox, np.float32), device=self.device)
        self.state = self._fns.init(
            self.vit_params, self._frame(frame), bbox_t, int(self.cfg.filter.seed)
        )

    def step(self, frame) -> dict[str, Any]:
        """Track one frame; returns a host-side record (one device-to-host copy)."""
        if self.state is None:
            raise RuntimeError("call init() or resume() first")
        t0 = time.perf_counter()
        self.state, out = self._fns.step(self.vit_params, self.state, self._frame(frame))
        rec = self._to_record(out)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3
        return rec

    def save(self, path: str) -> None:
        if self.state is None:
            raise RuntimeError("nothing to save before init()")
        save_tracker_state(path, self.state)

    def resume(self, path: str) -> None:
        """Restore a saved state; later steps continue its trajectory."""
        self.state = load_tracker_state(path, self.device)

    @staticmethod
    def _to_record(out: TrackOutput) -> dict[str, Any]:
        v = pack_track_output(out).cpu().numpy().astype(np.float64)
        return {
            "position": [float(v[0]), float(v[1])],
            "box": [float(v[2]), float(v[3])],
            "velocity": [float(v[4]), float(v[5])],
            "conf": float(v[6]),
            "ess": float(v[7]),
            "resampled": bool(v[8]),
            "lost": bool(v[9]),
        }

    def run(self, source, sink=None, init_bbox=None):
        """Track a whole source; yields per-frame records."""
        it = iter(source)
        frame0 = next(it)
        bbox = init_bbox
        if bbox is None:
            bbox = getattr(source, "init_bbox", None)
        if bbox is None:
            bbox = self.cfg.io.init_bbox
        self.init(frame0, bbox)
        for i, frame in enumerate(it):
            rec = self.step(frame)
            rec["frame"] = i + 1
            if sink is not None:
                sink.write(rec)
            yield rec
