"""Tracker orchestration: init(frame, bbox) / step(frame) — the port of the
JAX package's ``runtime/tracker.py``.

A dense-mode step: propagate -> window extraction -> one ViT forward ->
fused per-cell cosine scoring -> masked z-norm -> pf_update -> template EMA
with anchor mix -> lost and coast bookkeeping. A crop-mode step samples one
crop per particle instead (``tracker.crop_impl``: from the frame, or from one
resampled search window through the plain version or kernel K2), embeds all
N crops in one ViT forward with position embeddings, mean-pools them and
scores each against the template. The JAX version is one jitted program
with ``lax.cond`` for its two lost-only branches: the probe (dense mode
only) on the lost flag, the global re-detection scan on lost_count reaching
redetect_global_after. Here each is a body run through a ``run_if`` on a
predicate the step computes: an IF node of the captured CUDA graph on the
card (runtime/step_graph.py), a host branch in the eager step.

Ported: dense and crop mode with the lost gate and probe, template EMA and
anchor, coasting, the residual head's blend (static, or automatic for the
likelihood), global re-detection (the tiled scan in dense mode, one flat
grid of crops in crop mode) with its reseed, the ROI streaming step (a
StreamFrame: a tracking view and a decimated global view) and its chunk of
C steps, the Tracker class and the name-keyed state npz shared with the
JAX package.

The step takes an optional leading bank axis on every state leaf (K
independent filters, each with its own seed, in one batched step: one ViT
forward at B = K), which is how ``runtime/banked.py`` gets the JAX
package's ``vmap`` of this same step. On a mesh (``parallel/mesh.py``, the
JAX package's ``runtime.mesh_*``) each rank runs the step with its share of
the particle scoring and of the ViT, the collectives inside the step.
"""

from __future__ import annotations

import functools
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
    FrameView,
    StreamFrame,
    frame_to_window_coords,
    full_view,
    imagenet_stats,
    view_extract_window_mxu,
)
from vitparticlefiltertracker_tpu_torch.ops.likelihood import (
    _cos_to_template,
    auto_blend_target,
    cosine_log_likelihood,
    l2_normalize_split,
    landscape_spread,
    znormed_logits_from_cos,
)
from vitparticlefiltertracker_tpu_torch.ops.patchify import gather_patchify
from vitparticlefiltertracker_tpu_torch.ops.patchify_window import (
    window_gather_patchify,
    window_gather_patchify_plain,
)
from vitparticlefiltertracker_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    check_tp_divisibility,
    make_mesh,
    vit_param_shard,
)
from vitparticlefiltertracker_tpu_torch.runtime.step_graph import (
    RunIf,
    StepGraphs,
    clone_state,
    copy_state_,
    run_if_host,
)
from vitparticlefiltertracker_tpu_torch.utils.platform import resolve_device


class TrackerState(NamedTuple):
    """Tracker state; every leaf is a tensor on the tracker's device (with a
    leading K axis for K banks)."""

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
    """Flatten a TrackOutput into one f32 vector [10] ([10 K] for K banks):
    the fields in order, each raveled and cast to f32 (the JAX package's
    layout: all K positions, then all K boxes, and so on)."""
    return torch.cat([x.reshape(-1).to(torch.float32) for x in out])


_FIELD_WIDTHS = (2, 2, 2, 1, 1, 1, 1)  # TrackOutput's fields, values a bank


def unpack_track_output(packed: torch.Tensor, banks: int | None = None) -> TrackOutput:
    """pack_track_output's inverse on rows [..., 10] -> TrackOutput with the
    leading axes (views of `packed`; the two flags compared to 0). With
    `banks` K, rows [..., 10 K] -> fields with [..., K] leading axes."""
    k = 1 if banks is None else banks
    lead = packed.shape[:-1] if banks is None else (*packed.shape[:-1], k)
    fields, i = [], 0
    for width in _FIELD_WIDTHS:
        x = packed[..., i:i + width * k]
        fields.append(x.reshape(*lead, width) if width > 1 else x.reshape(lead))
        i += width * k
    *values, resampled, lost = fields
    return TrackOutput(*values, resampled=resampled != 0, lost=lost != 0)


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
    return search_scale * torch.sqrt(box_wh[..., 0] * box_wh[..., 1]) * scale


def _float_view(v: FrameView) -> FrameView:
    return FrameView(v.pixels.to(torch.float32), v.origin, v.stride)


def _frame_views(frame) -> tuple[FrameView, FrameView]:
    """The step's frame input as (tracking view, global view): a raw frame
    [H, W, 3] (or one a bank) is one full view for both; a StreamFrame gives
    its ROI to the tracking path and its decimated whole frame to global
    re-detection and the frame bounds."""
    if isinstance(frame, StreamFrame):
        return _float_view(frame.track), _float_view(frame.glob)
    v = full_view(frame.to(torch.float32))
    return v, v


def _frame_dims(gview: FrameView) -> tuple[int, int]:
    """The full frame's (h, w) px as the global view implies them: exact at
    stride 1, over by up to a stride for a decimated view (the JAX package's
    formula, which the bounds and the scan grid use)."""
    return int(gview.pixels.shape[-3] * gview.stride), int(gview.pixels.shape[-2] * gview.stride)


def _flag_like(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-bank flag [...] with trailing axes of 1 to broadcast against `like`."""
    return flag.reshape(*flag.shape, *[1] * (like.dim() - flag.dim()))


def _norm_folded_embed_weights(prm: dict, spec: VitSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold pixel normalization into the patch-embed affine map:
    ((x - m)/s) @ K = x @ (K / s_per_channel) - ((m/s) @ K). Crop mode samples
    raw frames with it; the dense path normalizes the window instead."""
    kern_f = prm["patch_embed"]["kernel"].float()  # [p*p*3, D]
    dev = kern_f.device
    mean, std = imagenet_stats(torch.float32, dev)
    mean, std = mean * 255.0, std * 255.0
    k3 = kern_f.reshape(-1, 3, spec.dim)
    kern_scaled = (k3 / std[None, :, None]).reshape(-1, spec.dim)
    bias_shift = torch.einsum("pcd,c->d", k3, mean / std)
    bias = prm["patch_embed"]["bias"].float() - bias_shift
    return kern_scaled.to(spec.dtype), bias.to(spec.dtype)


def seed_key(seed, device) -> torch.Tensor:
    """[2] int64 (hi, lo) 32-bit words of a seed ([K, 2] for a list of K)."""
    seeds = [int(x) & 0xFFFFFFFFFFFFFFFF for x in (seed if isinstance(seed, (list, tuple)) else [seed])]
    words = torch.tensor([[s >> 32, s & 0xFFFFFFFF] for s in seeds], dtype=torch.int64, device=device)
    return words if isinstance(seed, (list, tuple)) else words[0]


def key_seed(key: torch.Tensor):
    """seed_key's inverse: an int for [2], a list of K ints for [K, 2]."""
    seeds = [(hi << 32) | lo for hi, lo in key.reshape(-1, 2).tolist()]
    return seeds if key.dim() > 1 else seeds[0]


class _Fns(NamedTuple):
    init: Callable
    step: Callable
    track_clip: Callable
    track_chunk: Callable


def step_branches(cfg: Config) -> tuple[bool, int]:
    """The step's two lost-only branches as the config sets them: (whether a
    lost state runs the probe, lost frames in a row that trigger the global
    scan, 0 = never)."""
    f = cfg.filter
    probe = cfg.tracker.mode == "dense" and (f.lost_conf_threshold > 0.0 or f.lost_conf_ratio > 0.0)
    return probe, cfg.tracker.redetect_global_after


def refuse_cross_card_branches(cfg: Config, mesh: Mesh) -> None:
    """Raise NotImplementedError for a step graph whose IF-node bodies would
    hold collectives across cards: a "model" axis above 1 puts all-reduces
    in every ViT forward, and the probe's and the scan's bodies run one.
    NCCL collectives across cards inside a conditional node fail to capture
    (on 4 H100s: "CUDA error: invalid argument" at the capture's end; at one
    rank NCCL moves nothing and the capture holds). The eager step
    (graphs=False) branches on the host and is not refused."""
    probe, n_after = step_branches(cfg)
    if mesh.shape["model"] > 1 and (probe or n_after > 0):
        raise NotImplementedError(
            f"runtime.mesh_model {mesh.shape['model']} with the step's lost-only branches (the probe or global "
            "re-detection): their IF-node bodies would hold all-reduces across cards, which NCCL does not capture "
            "in a conditional node; use graphs=False, mesh_model 1, or a config without the branches "
            "(ROADMAP.md §3, F6)"
        )


def build_tracker_fns(cfg: Config, mesh: Mesh | None = None) -> _Fns:
    """Build (init_fn, step_fn, track_clip_fn, track_chunk_fn) for a dense- or
    crop-mode config.

    init(params, frame, bbox, seed, cloud=None) -> TrackerState
    step(params, state, frame, noise=None, reseed=None, run_if=None)
        -> (TrackerState, TrackOutput)
    track_clip(params, state, frames, noises=None, reseeds=None)
        -> (TrackerState, TrackOutput with a leading T axis)
    track_chunk(params, state, chunk, noises=None, reseeds=None, run_if=None)
        -> (TrackerState, TrackOutput with a leading C axis)

    frame: [H, W, 3] tensor (uint8 or float, 0..255) on the run's device, or
    (step only) a StreamFrame: the ROI streaming path, where the tracking
    view feeds the embedder and the template EMA, and the decimated global
    view the re-detection scan and the frame bounds. chunk: a StreamFrame of
    C stacked tracking views over one global view.
    cloud / noise / reseed: optional injected initial particles, step draws
    and [N, 2] re-detection reseed normals (parity runs); by default they are
    drawn from generators keyed on (seed, frame).

    K banks: init with bboxes [K, 4] and K seeds gives a state with a leading
    K on every leaf, and the same step advances all K in one batched step
    (frame [H, W, 3] shared by the banks, or [K, H, W, 3], one each; noise
    and reseed with a leading K; outputs [K, ...]). Bank k's draws are those
    of a single filter with its seed at its own frame index.

    The step's two lost-only branches (``lax.cond`` in the JAX package) run
    through run_if(pred, body), pred a 0-d bool tensor the step computes:
    the probe (dense mode, a lost gate configured) on `state.lost.any()`,
    the global scan (redetect_global_after > 0) on the step's own lost
    count reaching redetect_global_after for any bank. Each body writes into
    buffers that hold the not-taken values before it (the probe's gate
    confidence defaults to the step's confidence; the scan's match to the
    state's centre at cosine -2 and z 0, which nothing accepts), and the
    merges after the branches take a bank's branch result only where its
    own flag says so, so a body run where its predicate is false changes
    nothing. run_if None: the host reads the predicate and runs the body
    where it holds (step_graph.run_if_host). Given a run_if that reads
    nothing (the capture's IF nodes, or one that always runs the body), and
    noise and, with the scan configured, reseed, the step is capturable in
    a CUDA graph: no host read and no copy from host memory runs in it.

    mesh (parallel/mesh.py): the step of one rank of a mesh, its parameters
    this rank's (vit_param_shard). The ViT runs tensor-parallel over
    "model"; the per-particle scoring (the fused scorer, or a crop each
    through K2 and the ViT) runs on this rank's contiguous N / P slice of
    the particles and its results are all-gathered over "particle"; the
    state stays whole on every rank, and everything after the scoring runs
    on the full vectors, as without a mesh. So every rank computes the same
    state and the same branch predicates.
    """
    t = cfg.tracker
    m = cfg.model
    mode = t.mode
    n = cfg.filter.num_particles
    if mesh is not None:
        check_tp_divisibility(m.heads, m.mlp_dim, mesh.shape["model"])
        if n % mesh.shape["particle"]:
            raise ValueError(f"filter.num_particles {n} must divide by the particle axis {mesh.shape['particle']}")
    if mode == "crop":
        # Each crop is its own image of crop_size px, position embeddings on
        # (the first g*g rows of pos_embed).
        spec = VitSpec.from_config(m)._replace(image_size=t.crop_size, mesh=mesh)
        split = None
    else:
        es = DenseEmbedSpec.from_config(cfg)
        es = es._replace(vit=es.vit._replace(mesh=mesh))
        split = es.split
    pfp = _pf_params(cfg)
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
    probe_gated, n_after = step_branches(cfg)

    def f32(x, dev):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    consts: dict = {}

    def frame_consts(fh: int, fw: int, dev) -> dict:
        """Per-frame-size constants, built once per (size, device) and reused
        by every later step (a copy from host memory inside a step would be a
        wait for the card, and is not allowed in a captured graph)."""
        key = (fh, fw, dev)
        if key not in consts:
            consts[key] = {
                "frame_max": torch.tensor([fw - 1, fh - 1], dtype=torch.float32, device=dev),
                "cell_sigma": (torch.tensor([fw / g, fh / g], dtype=torch.float32, device=dev) / 4.0
                               if n_after > 0 else None),
                "frame_center": torch.tensor([fw / 2.0, fh / 2.0], dtype=torch.float32, device=dev),
                "frame_side": f32(max(fh, fw), dev),
            }
        return consts[key]

    def crop_embeddings(prm, view: FrameView, center, side, boxes_xy, boxes_wh):
        """Gather + patchify + embed every box's crop, then one batched ViT
        forward -> ([..., N, D] pooled embeddings, [..., N] all-True
        validity); leading axes: a search window (center [..., 2], side
        [...]) a bank, all banks' crops in one forward."""
        kern, bias = _norm_folded_embed_weights(prm, spec)
        if t.crop_impl == "frame":
            # Sample in the view's pixel coordinates.
            inv = 1.0 / float(view.stride)
            tokens = gather_patchify(
                view.pixels, (boxes_xy - view.origin) * inv, boxes_wh * inv,
                t.crop_size, m.patch_size, kern, bias, region=t.crop_region,
            )
        else:
            # Two stages: resample one search window a bank, then every
            # particle's crop from it (K2 on the card for window-pallas, one
            # launch for all banks).
            swin = t.window_size
            window = view_extract_window_mxu(view, center, side, swin)
            center, side = center[..., None, :], side[..., None, None]
            ctr_win = frame_to_window_coords(boxes_xy, center, side, swin)
            wh_win = boxes_wh * (swin / side)
            embed = window_gather_patchify if t.crop_impl == "window-pallas" else window_gather_patchify_plain
            tokens = embed(window, ctr_win, wh_win, t.crop_size, m.patch_size, kern, bias)
        lead = boxes_xy.shape[:-1]
        feats = encode_tokens(prm, tokens.reshape(-1, *tokens.shape[-2:]), spec)
        ok = torch.ones(lead, dtype=torch.bool, device=boxes_xy.device)
        return pool_tokens(feats, spec).reshape(*lead, -1), ok

    def make_embedder(prm, view: FrameView, center, side):
        if mode == "dense":
            return make_dense_embedder(prm, view, center, side, es)
        return lambda bxy, bwh: crop_embeddings(prm, view, center, side, bxy, bwh)

    def score_particles(score, boxes_xy, boxes_wh):
        """score(boxes_xy, boxes_wh) -> per-particle rows ([..., N] tensors,
        the last the in-window mask). Under a mesh, on this rank's slice of
        the particles, then all-gathered over "particle" in one collective."""
        if mesh is None:
            return score(boxes_xy, boxes_wh)
        per = n // mesh.shape["particle"]
        lo = mesh.coords["particle"] * per
        rows = score(boxes_xy[..., lo:lo + per, :], boxes_wh[..., lo:lo + per, :])
        local = torch.stack([r.to(torch.float32) for r in rows])  # [R, ..., N / P]
        whole = all_gather(local, mesh, "particle").movedim(0, -2).reshape(*local.shape[:-1], n)
        return tuple(w != 0 if r.dtype == torch.bool else w.to(r.dtype) for w, r in zip(whole, rows))

    def init_fn(prm, frame, bbox: torch.Tensor, seed, cloud=None) -> TrackerState:
        """bbox: [4] (x, y, w, h) frame px and one seed; or [K, 4] and K
        seeds for K banks, every state leaf then with a leading K (frame
        [H, W, 3] shared, or [K, H, W, 3], a frame a bank). Template and
        cloud init."""
        dev = bbox.device
        lead = bbox.shape[:-1]
        if lead:
            seed = [int(s) for s in seed]
            if len(seed) != lead[0]:
                raise ValueError(f"{lead[0]} boxes but {len(seed)} seeds")
        view = full_view(frame.to(torch.float32))
        center = bbox[..., :2] + bbox[..., 2:] / 2.0
        box_wh = bbox[..., 2:]
        side = _window_side(box_wh, 1.0, t.search_scale)
        emb, _ = make_embedder(prm, view, center, side)(center[..., None, :], box_wh[..., None, :])
        template = l2_normalize_split(emb.select(len(lead), 0).float(), split)
        pf = init_state(seed, center, n, pfp, cloud=cloud)

        def full(value, dtype=torch.float32):
            return torch.full(lead, value, dtype=dtype, device=dev)

        return TrackerState(
            pf=pf,
            template=template,
            anchor=template,
            box_wh=box_wh,
            center=center,
            prev_scale=full(1.0),
            key=seed_key(seed, dev),
            frame_idx=full(0, torch.int32),
            conf=full(1.0),
            lost=full(False, torch.bool),
            lost_count=full(0, torch.int32),
            conf_ema=full(-1.0),
            coast_xy=center,
            coast_vel=torch.zeros((*lead, 2), dtype=torch.float32, device=dev),
            coast_acc=torch.zeros((*lead, 2), dtype=torch.float32, device=dev),
            blend=full(-1.0),
        )

    g = t.redetect_global_grid
    c_sub = 3  # candidate sub-grid per tile (dense tiled scan)

    def global_scan(prm, view: FrameView, tmpl, side, cand_wh):
        """Score a grid of candidate boxes of size cand_wh [..., 2] over the
        whole frame (`view`: the global view) against the template -> (best_xy [..., 2], best_cos
        [...], best_z [...]), z being the winner's margin over the valid
        candidates in standard deviations; each bank of a leading axis scans
        with its own template, window side and box.

        Dense mode tiles the frame with G*G windows at about the local
        search's scale (one batched ViT forward for all banks) and C*C
        candidates a tile; crop mode embeds the G*G tile centres as crops of
        one whole-frame window. A function of tensors only, so a captured
        step can hold it."""
        dev = cand_wh.device
        lead = cand_wh.shape[:-1]
        h_px, w_px = _frame_dims(view)
        fc = frame_consts(h_px, w_px, dev)
        gxs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * (w_px / g)
        gys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) * (h_px / g)
        # Row-major [G*G, 2]; expand + reshape repeats each y without the
        # host read of repeat_interleave.
        tile_ctrs = torch.stack([gxs.repeat(g), gys[:, None].expand(g, g).reshape(-1)], dim=-1)
        tile_ctrs = tile_ctrs.expand(*lead, g * g, 2)
        frame_side = fc["frame_side"]
        if mode == "dense":
            tile_side = torch.maximum(1.25 * frame_side / g, side)
            oxs = (torch.arange(c_sub, dtype=torch.float32, device=dev) - (c_sub - 1) / 2) * (w_px / (g * c_sub))
            oys = (torch.arange(c_sub, dtype=torch.float32, device=dev) - (c_sub - 1) / 2) * (h_px / (g * c_sub))
            offs = torch.stack([oxs.repeat(c_sub), oys[:, None].expand(c_sub, c_sub).reshape(-1)], dim=-1)  # [C*C, 2]
            cand = tile_ctrs[..., :, None, :] + offs  # [..., G*G, C*C, 2]
            emb, valid = tiled_window_embed(prm, view, tile_ctrs, tile_side, es, cand, cand_wh)
            emb = emb.reshape(*lead, g * g * c_sub * c_sub, *emb.shape[len(lead) + 2:])
            valid = valid.reshape(*lead, -1)
            cand = cand.reshape(*lead, -1, 2)
        else:
            cand = tile_ctrs
            emb, valid = crop_embeddings(prm, view, fc["frame_center"].expand(*lead, 2), frame_side.expand(lead),
                                         cand, cand_wh[..., None, :].expand(cand.shape))
        _, cos = cosine_log_likelihood(emb, tmpl, 1.0, split=split, batch_dims=len(lead))
        cos = torch.where(valid, cos, -2.0)
        # A [..., 1] index taken with gather, not a 0-d one: indexing with a
        # 0-d tensor reads it back to the host.
        b = torch.argmax(cos, dim=-1, keepdim=True)
        nv = torch.clamp(valid.sum(dim=-1), min=1)
        mu = torch.sum(torch.where(valid, cos, 0.0), dim=-1) / nv
        var = torch.sum(torch.where(valid, (cos - mu[..., None]) ** 2, 0.0), dim=-1) / nv
        best_cos = torch.gather(cos, -1, b)[..., 0]
        z = (best_cos - mu) * torch.rsqrt(var + 1e-8)
        best_xy = torch.gather(cand, -2, b[..., None].expand(*lead, 1, 2))[..., 0, :]
        return best_xy, best_cos, z

    def step_fn(prm, state: TrackerState, frame, noise: StepNoise | None = None,
                reseed: torch.Tensor | None = None, run_if: RunIf | None = None):
        run_if = run_if_host if run_if is None else run_if
        dev = state.center.device
        lead = state.center.shape[:-1]  # () for one filter, (K,) for K banks
        nb = len(lead)
        view, gview = _frame_views(frame)
        fc = frame_consts(*_frame_dims(gview), dev)
        if noise is None:
            noise = draw_step_noise(key_seed(state.key), state.frame_idx.tolist(), n, dev)
        # While lost, sweep a wider area: inflate position diffusion and the
        # search window until re-lock.
        noise_boost = torch.where(state.lost, t.redetect_noise_boost, 1.0)
        noise = noise._replace(pos=noise.pos * noise_boost[..., None, None])
        particles = propagate(state.pf.particles, noise, pfp.motion)

        side = _window_side(state.box_wh, state.prev_scale, t.search_scale)
        side = side * torch.where(state.lost, t.redetect_window_boost, 1.0)
        boxes_xy = particles[..., 0:2]
        boxes_wh = state.box_wh[..., None, :] * torch.exp(particles[..., 4:5])
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
            cos_f, cos_h, in_win = score_particles(functools.partial(pool.score_halves, tmpl), boxes_xy, boxes_wh)
            b_run = torch.where(state.blend >= 0.0, state.blend, ab_init)
            b_static = split[1]
            cos = (1.0 - b_static) * cos_f + b_static * cos_h
            # Confusion: the spatial spread of the trunk landscape's top slice,
            # in box diagonals.
            spread = landscape_spread(cos_f, boxes_xy, m.head_blend_top_frac, mask=in_win)
            box_diag = torch.linalg.vector_norm(state.box_wh, dim=-1) * state.prev_scale
            b_tgt = auto_blend_target(spread, box_diag, m.head_blend_spread_lo, m.head_blend_spread_hi,
                                      m.head_blend_min, m.head_blend_max)
            b_use = torch.where(state.lost, b_static, torch.maximum(b_run, b_tgt))[..., None]
            cos_loc = (1.0 - b_use) * cos_f + b_use * cos_h
            loglik = znormed_logits_from_cos(cos_loc, zscale, mask=in_win) if use_znorm else temp * cos_loc
        elif mode == "dense":
            cos, in_win = score_particles(functools.partial(pool.score, tmpl), boxes_xy, boxes_wh)
            if use_znorm:
                # Masked stats: out-of-window particles' clamped-edge cosines
                # must not skew mu/sd.
                loglik = znormed_logits_from_cos(cos, zscale, mask=in_win)
            else:
                loglik = temp * cos
        else:
            def crop_cos(bxy, bwh):
                emb, ok = pool(bxy, bwh)
                return _cos_to_template(emb, tmpl, split, nb), ok

            cos, in_win = score_particles(crop_cos, boxes_xy, boxes_wh)
            loglik = znormed_logits_from_cos(cos, zscale, mask=in_win) if use_znorm else temp * cos
        loglik = torch.where(in_win, loglik, loglik - 1e4)

        out = pf_update(particles, state.pf.log_weights, loglik, noise.resample_u, pfp)
        if t.estimate == "mode":
            best = torch.argmax(state.pf.log_weights + loglik, dim=-1, keepdim=True)
            est = torch.gather(particles, -2, best[..., None].expand(*lead, 1, particles.shape[-1]))[..., 0, :]
        else:
            est = out.estimate
        est_xy = est[..., 0:2]
        est_scale = torch.exp(est[..., 4])
        est_box = (state.box_wh * est_scale[..., None])[..., None, :]  # [..., 1, 2]
        # Confidence = best valid cosine; all-out-of-window gives -1.
        conf = torch.amax(torch.where(in_win, cos, -1.0), dim=-1)
        if probe_gated:
            # While lost the window is boosted, which depresses every cosine;
            # probe the estimate through an unboosted window instead (one
            # extra ViT forward, on lost frames only). Crop mode embeds at
            # the box's own scale already and has no probe. With banks the
            # probe runs for all while any is lost, and each takes its result
            # where it was lost (what JAX's vmap makes of the lax.cond).
            conf_gate = conf.clone()  # the not-taken value

            def probe():
                side0 = _window_side(state.box_wh, state.prev_scale, t.search_scale)
                pool_p = make_dense_embedder(prm, view, est_xy, side0, es)
                emb_p, ok_p = pool_p(est_xy[..., None, :], est_box)
                _, cos_p = cosine_log_likelihood(emb_p, tmpl, 1.0, split=split, batch_dims=nb)
                conf_gate.copy_(torch.where(state.lost, torch.where(ok_p[..., 0], cos_p[..., 0], -1.0), conf))

            run_if(state.lost.any(), probe)
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
            est_emb, _ = pool(est_xy[..., None, :], est_box)
            cand = l2_normalize_split(
                (1.0 - ema) * state.template
                + ema * l2_normalize_split(est_emb.select(nb, 0).float(), split),
                split,
            )
            do_upd = (conf > upd_conf) & ~lost & ~state.lost
            template = torch.where(_flag_like(do_upd, cand), cand, state.template)
        else:
            template = state.template

        # When lost, freeze the search window instead of chasing noise.
        new_center = torch.where(lost[..., None], state.center, est_xy)
        lost_count = torch.where(lost, state.lost_count + 1, torch.zeros_like(state.lost_count))
        new_pf = out.state
        scale_frozen = lost  # prev_scale keeps the pre-reseed lost flag
        accepted = torch.zeros_like(lost)
        est_out = est_xy

        # Global re-detection: after redetect_global_after lost frames in a
        # row, scan a grid over the whole frame against the template and, on
        # an accepted match, reseed the cloud there (lax.cond in the JAX
        # package; here a body on the trigger of any bank, its effects gated
        # on each bank's own trigger).
        if n_after > 0:
            trigger = lost_count >= n_after
            # The not-taken values (JAX's false branch): no match to accept.
            best_xy = state.center.clone()
            best_cos = torch.full(lead, -2.0, dtype=torch.float32, device=dev)
            best_z = torch.zeros(lead, dtype=torch.float32, device=dev)

            def scan():
                cand_wh = state.box_wh * state.prev_scale[..., None]
                for buf, value in zip((best_xy, best_cos, best_z), global_scan(prm, gview, tmpl, side, cand_wh)):
                    buf.copy_(value)

            run_if(trigger.any(), scan)
            accept = trigger & (best_cos >= t.redetect_accept_conf) & (best_z >= t.redetect_accept_z)
            if t.redetect_accept_ratio > 0:
                # A fraction of the locked-state confidence EMA, skipped while
                # unseeded.
                accept = accept & ((state.conf_ema <= 0) | (best_cos >= t.redetect_accept_ratio * state.conf_ema))
            if reseed is None:
                reseed = draw_reseed_noise(key_seed(state.key), state.frame_idx.tolist(), n, dev)
            # A fresh cloud spread over the winning grid cell, zero velocity,
            # uniform weights.
            reseeded = torch.cat([best_xy[..., None, :] + fc["cell_sigma"] * reseed,
                                  torch.zeros((*lead, n, 2), dtype=torch.float32, device=dev),
                                  new_pf.particles[..., 4:]], dim=-1)
            uniform_w = torch.full((n,), -math.log(n), dtype=torch.float32, device=dev)
            new_pf = PFState(particles=torch.where(accept[..., None, None], reseeded, new_pf.particles),
                             log_weights=torch.where(accept[..., None], uniform_w, new_pf.log_weights))
            new_center = torch.where(accept[..., None], best_xy, new_center)
            lost_count = torch.where(accept, torch.zeros_like(lost_count), lost_count)
            # An accepted match is the re-acquisition and clears `lost`, unless
            # re-lock hysteresis is on: then the next step's unboosted probe
            # must clear relock_conf_ratio first.
            if relock_ratio <= 0.0:
                lost = lost & ~accept
            accepted = accept
            est_out = torch.where(accept[..., None], best_xy, est_xy)

        # Lost-aware output: while lost the reported trajectory coasts on the
        # last-locked position and velocity (plus the clipped acceleration
        # EMA), clamped to the frame; the filter itself is untouched. An
        # accepted global match snaps the output to the match and resets the
        # coast.
        frame_max = fc["frame_max"]
        est_vel = est[..., 2:4]
        zero2 = torch.zeros_like(est_vel)
        a_ema = t.coast_accel_ema
        acc_upd = torch.clamp(
            (1.0 - a_ema) * state.coast_acc + a_ema * (est_vel - state.coast_vel),
            -t.coast_accel_clip,
            t.coast_accel_clip,
        )
        lost2, accepted2 = lost[..., None], accepted[..., None]
        coast_acc = torch.where(lost2, state.coast_acc, torch.where(accepted2, zero2, acc_upd))
        vel_lost = state.coast_vel + state.coast_acc
        coast_xy = torch.where(
            lost2, torch.clamp(state.coast_xy + vel_lost, min=torch.zeros_like(frame_max), max=frame_max), est_out
        )
        coast_vel = torch.where(lost2, vel_lost, torch.where(accepted2, zero2, est_vel))
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
            box=state.box_wh * torch.where(lost, state.prev_scale, est_scale)[..., None],
            velocity=coast_vel,
            conf=conf_gate,
            ess=out.ess,
            resampled=out.resampled,
            lost=lost,
        )
        return new_state, track_out

    def track_clip_fn(prm, state: TrackerState, frames, noises=None, reseeds=None):
        """T sequential steps over frames [T, ...] (a frame, or K frames, a
        step) -> (state, TrackOutput with a leading T axis); noises /
        reseeds: optional per-frame draws."""
        outs = []
        for i in range(frames.shape[0]):
            state, out = step_fn(prm, state, frames[i], None if noises is None else noises[i],
                                 None if reseeds is None else reseeds[i])
            outs.append(out)
        return state, TrackOutput(*(torch.stack(x) for x in zip(*outs)))

    def track_chunk_fn(prm, state: TrackerState, chunk: StreamFrame, noises=None, reseeds=None, run_if=None):
        """C sequential steps over chunk.track's stacked views (pixels
        [C, h, w, 3], origins [C, 2]) sharing chunk.glob -> (state,
        TrackOutput with a leading C axis): the same as C step calls on the
        single StreamFrames. noises / reseeds: optional draws, one a frame."""
        tv = chunk.track
        outs = []
        for i in range(tv.pixels.shape[0]):
            sf = StreamFrame(track=FrameView(tv.pixels[i], tv.origin[i], tv.stride), glob=chunk.glob)
            state, out = step_fn(prm, state, sf, None if noises is None else noises[i],
                                 None if reseeds is None else reseeds[i], run_if)
            outs.append(out)
        return state, TrackOutput(*(torch.stack(x) for x in zip(*outs)))

    return _Fns(init=init_fn, step=step_fn, track_clip=track_clip_fn, track_chunk=track_chunk_fn)


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


class StagingRing:
    """Pinned host slots for arrays on their way to the card (frames, ROI
    crops, their origins, global views), `depth` slots an array shape and
    dtype (or the depth ``reserve`` set for it), used in turn. A host array
    is copied into the next slot; the step's copy from that slot to the card
    records the slot's event (``copied``). A slot is written again only once
    its event has passed: when the host runs `depth` arrays of a shape ahead
    of the card's copies, ``stage`` waits for the oldest one, and counts the
    wait in `waits`."""

    def __init__(self, depth: int = 2):
        self.depth = depth
        self.waits = 0
        self._slots: dict = {}  # (shape, dtype) -> [(pinned tensor, event), ...]
        self._turn: dict = {}  # (shape, dtype) -> arrays staged
        self._depths: dict = {}  # (shape, dtype) -> its depth, where reserve set one
        self._pending: list = []  # slots staged whose copy to the card is not enqueued yet

    def reserve(self, frame: np.ndarray, depth: int | None = None) -> None:
        """Allocate the slots for arrays like `frame` now (a pinned
        allocation costs the host about a millisecond a frame): `depth` of
        them, or the ring's depth."""
        key = (tuple(frame.shape), torch.from_numpy(np.ascontiguousarray(frame[:0])).dtype)
        if depth is not None:
            self._depths[key] = depth
        slots = self._slots.setdefault(key, [])
        while len(slots) < self._depths.get(key, self.depth):
            slots.append((torch.empty(key[0], dtype=key[1]).pin_memory(), torch.cuda.Event()))

    def stage(self, frame: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(frame))
        key = (tuple(src.shape), src.dtype)
        slots = self._slots.setdefault(key, [])
        turn = self._turn.get(key, 0)
        self._turn[key] = turn + 1
        if len(slots) < self._depths.get(key, self.depth) and turn >= len(slots):  # grow as arrays come
            slots.append((torch.empty(src.shape, dtype=src.dtype).pin_memory(), torch.cuda.Event()))
            slot = slots[-1]
        else:
            slot = slots[turn % len(slots)]
            if not slot[1].query():
                self.waits += 1
                slot[1].synchronize()
        slot[0].copy_(src)
        self._pending.append(slot)
        return slot[0]

    def copied(self, frame: torch.Tensor) -> None:
        """The copy from `frame` to the card is enqueued on the current
        stream: record its slot's event there (if it is a staged slot)."""
        for i, slot in enumerate(self._pending):
            if slot[0] is frame:
                slot[1].record()
                del self._pending[i]
                return


class _GraphStepper:
    """The machinery shared by Tracker and the banked trackers
    (runtime/banked.py): the device-side steps .step_device, .step_packed and
    .track_clip_device over state with leading axes `lead` (() for one
    filter, (K,) for K banks).

    On the card each step is one replay of a CUDA graph, captured once per
    frame shape and dtype (at init, or at the first step of a new shape): the
    port's counterpart of the JAX package's one jitted step. The graph reads
    the state from static buffers and writes the new state back into them.
    With runtime.donate_state true, ``state`` is those buffers (updated in
    place, as JAX donates them); with false it is a copy taken after each
    step, which later steps leave alone. ``graphs=False`` runs the same step
    eagerly (the A/B of chip_smoke.py); a capture that fails raises. On the
    CPU the step runs eagerly.

    The step's noise is drawn on the host's call, keyed on (seed, frame
    index) of each bank, both kept on the host; with global re-detection
    configured, the reseed normals too, on every step. Its two lost-only
    branches are IF nodes of the graph, chosen on the card from the state
    (runtime/step_graph.py), so step_device, step_packed and
    track_clip_device wait for nothing on any config. The eager step
    chooses them on the host (a wait a branch).

    On a mesh (parallel/mesh.py) this object is one rank's: its weights are
    the rank's "model" shard, its step scores its "particle" slice, and its
    banks (`lead`) are its "bank" slice; the collectives are captured in the
    step's graph beside the kernels. The rows it returns hold every bank
    (all-gathered over "bank" after the step), so every rank returns the
    same outputs. On CUDA the rank's card is cuda:mesh.local_rank.
    """

    def _setup(self, cfg: Config, vit_params, device, graphs: bool, lead: tuple[int, ...],
               mesh: Mesh | None = None, banks: int | None = None) -> None:
        from vitparticlefiltertracker_tpu_torch.models.params import resolve_vit_params

        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            if mesh.backend != backend:
                raise ValueError(f"a {self.device.type} tracker needs a {backend} mesh, got {mesh.backend}")
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", mesh.local_rank)
        spec = VitSpec.from_config(cfg.model)._replace(mesh=mesh)
        if cfg.tracker.mode == "crop":
            spec = spec._replace(image_size=cfg.tracker.crop_size)
        self.spec = spec
        self._fns = build_tracker_fns(cfg, mesh)
        self.vit_params = self._shard(resolve_vit_params(cfg, vit_params, self.device))
        self.graphs = graphs and self.device.type == "cuda"
        if self.graphs and mesh is not None:
            refuse_cross_card_branches(cfg, mesh)
        self._donate = bool(cfg.runtime.donate_state)
        self._n_after = cfg.tracker.redetect_global_after
        self._n = cfg.filter.num_particles
        self._lead = lead
        self._k = int(np.prod(lead, dtype=np.int64))  # filters a step on this rank
        self._k_all = self._k if banks is None else banks  # filters a step on the mesh
        self._frame_sl: slice | None = None  # a multi-stream rank's streams of a frame batch
        self._state: TrackerState | None = None
        self._static: TrackerState | None = None  # the graph's state buffers
        self._step_graphs: dict = {}  # (frame shape, dtype) -> StepGraphs
        # ROI streaming: (stacked track shape, dtype, stride, glob shape,
        # dtype, stride) -> the chunk's StepGraphs; and the global view's
        # device buffers, one a glob shape and dtype, shared by those graphs.
        self._chunk_graphs: dict = {}
        self._globs: dict = {}  # (shape, dtype) -> [pixels, origin, the host tensor last copied in]
        self._pool = None
        self.staging = StagingRing()  # pinned host frame slots (CUDA)
        self._row_buf: torch.Tensor | None = None  # pinned host copy of a step's row (CUDA)
        # Host copies of what the next step's noise needs, one a bank
        # (arrays of shape `lead`): the seed and the frame index.
        self._seed = np.zeros(lead, np.int64)
        self._frame_idx = np.zeros(lead, np.int64)

    def load_weights(self, vit_params: dict) -> None:
        """Replace the weights by copying ``resolve_vit_params(cfg,
        vit_params)`` into the tensors the tracker holds, leaf by leaf (same
        names, shapes and dtypes, or ValueError). The step graphs captured so
        far read those tensors, so their next replays use the new weights;
        binding a new tree to ``vit_params`` would leave them reading the old
        ones. A tracker built on a caller's tensors (a float32 tree on its
        device is used as given) writes into them."""
        from vitparticlefiltertracker_tpu_torch.models.params import resolve_vit_params

        def copy_into(dst: dict, src: dict, path: str) -> None:
            if set(dst) != set(src):
                raise ValueError(f"load_weights: leaves under {path or '/'} differ: {sorted(dst)} != {sorted(src)}")
            for k, d in dst.items():
                s = src[k]
                if isinstance(d, dict):
                    copy_into(d, s, f"{path}/{k}")
                elif k == "pos_embed" and not path and d.shape != s.shape and self.cfg.tracker.mode == "dense":
                    continue  # dense mode never reads it: a tree trained at another window size loads
                elif d.shape != s.shape or d.dtype != s.dtype:
                    raise ValueError(f"load_weights: {path}/{k} is {tuple(s.shape)} {s.dtype}, the tracker holds "
                                     f"{tuple(d.shape)} {d.dtype}")
                elif d.data_ptr() != s.data_ptr():
                    d.copy_(s)

        with torch.no_grad():
            copy_into(self.vit_params, self._shard(resolve_vit_params(self.cfg, vit_params, self.device)), "")

    def _shard(self, params: dict) -> dict:
        """This rank's part of a weight tree (the whole tree without a mesh)."""
        return params if self.mesh is None else vit_param_shard(self.mesh, params)

    def _all_banks(self, row: torch.Tensor) -> torch.Tensor:
        """A step's [10 K_local] row -> the mesh's [10 K] row in the packed
        layout (each field's banks in global order): all-gathered over "bank"
        on a banked tracker's mesh; the row itself otherwise."""
        if self.mesh is None or not self._lead:
            return row
        rows = all_gather(row, self.mesh, "bank")  # [B, 10 K_local]
        k, fields, i = self._k, [], 0
        for width in _FIELD_WIDTHS:
            fields.append(rows[:, i * k:(i + width) * k].reshape(-1))
            i += width
        return torch.cat(fields)

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> TrackerState | None:
        return self._state

    def _adopt(self, state: TrackerState, seed, frame_idx) -> None:
        """Take `state` (on any device) and the host's copies of its noise
        seeds and frame indices."""
        state = TrackerState(*(x.to(self.device) if isinstance(x, torch.Tensor)
                               else PFState(*(y.to(self.device) for y in x)) for x in state))
        self._seed = np.broadcast_to(np.asarray(seed, np.int64), self._lead).copy()
        self._frame_idx = np.broadcast_to(np.asarray(frame_idx, np.int64), self._lead).copy()
        if not self.graphs:
            self._state = state
            return
        if self._static is None:
            self._static = clone_state(state)
        else:
            copy_state_(self._static, state)
        self._state = self._static if self._donate else clone_state(self._static)

    def _frame(self, frame) -> torch.Tensor:
        if isinstance(frame, torch.Tensor):
            return frame.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)

    def _start(self, frame, bboxes, seeds) -> None:
        """Template and cloud from the first frame (a frame, or one a bank)
        and boxes; on the card, also the step's graph at this frame shape
        (captured now, so no capture lands inside a run)."""
        bbox_t = torch.as_tensor(np.asarray(bboxes, np.float32), device=self.device)
        frame_t = self._frame(frame)
        self._adopt(self._fns.init(self.vit_params, frame_t, bbox_t, seeds), seeds, 0)
        if self.graphs:
            self._graphs_for(frame_t)

    # -- the step --------------------------------------------------------------
    def _body(self, state, frame, noise, reseed, run_if):
        """One step -> (new state, [10 K] f32 row: the packed TrackOutput,
        pack_track_output's layout); capturable with a run_if that reads
        nothing."""
        new, out = self._fns.step(self.vit_params, state, frame, noise=noise, reseed=reseed, run_if=run_if)
        return new, pack_track_output(out)

    def _graphs_for(self, frame: torch.Tensor) -> StepGraphs:
        """The StepGraphs of this frame's shape and dtype, captured on first sight."""
        key = (tuple(frame.shape), frame.dtype)
        if key not in self._step_graphs:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            buf = torch.zeros(frame.shape, dtype=frame.dtype, device=self.device)
            self._step_graphs[key] = StepGraphs(self._body, self._static, (buf,), self._n, self._pool, self._lead)
        return self._step_graphs[key]

    def _advance(self, frame: torch.Tensor) -> torch.Tensor:
        """One step on `frame` (a tensor on the device, or in pinned host
        memory) -> its [10 K] row on the device, enqueued, not waited for. On
        the card with graphs the row is the graph's buffer, valid until the
        next step."""
        if self._state is None:
            raise RuntimeError("call init() or resume() first")
        dev = self.device
        seeds, idx = self._seed.tolist(), self._frame_idx.tolist()
        noise = draw_step_noise(seeds, idx, self._n, dev)
        reseed = draw_reseed_noise(seeds, idx, self._n, dev) if self._n_after > 0 else None
        mine = frame if self._frame_sl is None else frame[self._frame_sl]
        if self.graphs:
            sg = self._graphs_for(mine)
            sg.inputs[0].copy_(mine, non_blocking=True)
            self.staging.copied(frame)
            for dst, src in zip(sg.noise, noise):
                dst.copy_(src)
            if reseed is not None:
                sg.reseed.copy_(reseed)
            row = sg.replay()
            if not self._donate:
                self._state = clone_state(self._static)
        else:
            frame_dev = mine.to(dev, non_blocking=True)
            self.staging.copied(frame)
            self._state, row = self._body(self._state, frame_dev, noise, reseed, None)
        self._frame_idx = self._frame_idx + 1
        return row

    # -- the ROI streaming step: chunks of StreamFrames ----------------------------
    def _chunk_body(self, state, pixels, origin, glob, glob_origin, noise, reseed, run_if, *, stride, glob_stride):
        """C steps over stacked tracking views [C, h, w, 3] (origins [C, 2])
        sharing one global view -> (new state, [C, 10] f32 rows, a frame's
        packed TrackOutput a row); noise and reseed with a leading C.
        Capturable as _body is."""
        c = pixels.shape[0]
        chunk = StreamFrame(FrameView(pixels, origin, stride), FrameView(glob, glob_origin, glob_stride))
        noises = [StepNoise(*(x[i] for x in noise)) for i in range(c)]
        new, outs = self._fns.track_chunk(self.vit_params, state, chunk, noises, reseed, run_if)
        return new, torch.cat([x.reshape(c, -1).to(torch.float32) for x in outs], dim=1)

    def _glob_entry(self, shape, dtype) -> list:
        key = (tuple(shape), dtype)
        if key not in self._globs:
            self._globs[key] = [torch.zeros(key[0], dtype=dtype, device=self.device),
                                torch.zeros(2, dtype=torch.float32, device=self.device), None]
        return self._globs[key]

    def _glob_view(self, glob: FrameView) -> FrameView:
        """A StreamFrame's global view in the tracker's device buffer for its
        shape: the one every ROI graph of that glob shape reads. The host's
        pixels (and origin) are copied in, on the current stream and so
        before the next replay, only when they are not the tensor the last
        step read: a view reused between refreshes is not copied again."""
        entry = self._glob_entry(glob.pixels.shape, glob.pixels.dtype)
        if entry[2] is not glob.pixels:
            entry[0].copy_(glob.pixels, non_blocking=True)
            self.staging.copied(glob.pixels)
            entry[1].copy_(glob.origin, non_blocking=True)
            self.staging.copied(glob.origin)
            entry[2] = glob.pixels
        return FrameView(entry[0], entry[1], glob.stride)

    def _chunk_graphs_for(self, track_shape, dtype, stride: float, glob: FrameView) -> StepGraphs:
        """The StepGraphs of a chunk of stacked tracking views
        [C, h, w, 3] over a global view in the tracker's buffers, captured
        on first sight."""
        key = (tuple(track_shape), dtype, float(stride), tuple(glob.pixels.shape), glob.pixels.dtype,
               float(glob.stride))
        if key not in self._chunk_graphs:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            inputs = (torch.zeros(track_shape, dtype=dtype, device=self.device),
                      torch.zeros((track_shape[0], 2), dtype=torch.float32, device=self.device),
                      glob.pixels, glob.origin)
            body = functools.partial(self._chunk_body, stride=float(stride), glob_stride=float(glob.stride))
            self._chunk_graphs[key] = StepGraphs(body, self._static, inputs, self._n, self._pool, self._lead,
                                                 steps=track_shape[0])
        return self._chunk_graphs[key]

    def prepare_stream(self, example: StreamFrame, sizes) -> None:
        """On the card with graphs: capture now (after init) the ROI step's
        graph for every chunk size in `sizes`, for tracking views and a
        global view shaped as `example`'s (one frame's, unstacked), so that
        no capture lands inside a stream. Elsewhere nothing to do."""
        if not self.graphs:
            return
        tv = example.track
        glob = self._glob_entry(example.glob.pixels.shape, example.glob.pixels.dtype)
        gview = FrameView(glob[0], glob[1], example.glob.stride)
        for c in sizes:
            self._chunk_graphs_for((c, *tv.pixels.shape), tv.pixels.dtype, tv.stride, gview)

    def _advance_chunk(self, chunk: StreamFrame) -> torch.Tensor:
        """C steps on a chunk (tracking pixels [C, h, w, 3] and origins
        [C, 2], on the device or staged; one global view) -> its [C, 10]
        rows on the device, enqueued, not waited for. On the card with
        graphs: one replay, the rows the graph's buffer, valid until its
        next replay. Frame i draws the noise of frame index idx + i, as C
        single steps would."""
        if self._state is None:
            raise RuntimeError("call init() or resume() first")
        if self._lead:
            raise ValueError("ROI streaming steps a single filter")
        tv = chunk.track
        c, dev = tv.pixels.shape[0], self.device
        seed, idx = int(self._seed), int(self._frame_idx)
        noises = [draw_step_noise(seed, idx + i, self._n, dev) for i in range(c)]
        reseeds = ([draw_reseed_noise(seed, idx + i, self._n, dev) for i in range(c)]
                   if self._n_after > 0 else None)
        glob = self._glob_view(chunk.glob)
        if self.graphs:
            sg = self._chunk_graphs_for(tv.pixels.shape, tv.pixels.dtype, tv.stride, glob)
            for buf, src in zip(sg.inputs, (tv.pixels, tv.origin)):
                buf.copy_(src, non_blocking=True)
                self.staging.copied(src)
            for i, noise in enumerate(noises):
                for dst, src in zip(sg.noise, noise):
                    dst[i].copy_(src)
                if reseeds is not None:
                    sg.reseed[i].copy_(reseeds[i])
            rows = sg.replay()
            if not self._donate:
                self._state = clone_state(self._static)
        else:
            pixels, origin = (x.to(dev, non_blocking=True) for x in (tv.pixels, tv.origin))
            self.staging.copied(tv.pixels)
            self.staging.copied(tv.origin)
            noise = StepNoise(*(torch.stack(x) for x in zip(*noises)))
            reseed = None if reseeds is None else torch.stack(reseeds)
            self._state, rows = self._chunk_body(self._state, pixels, origin, glob.pixels, glob.origin, noise, reseed,
                                                 None, stride=tv.stride, glob_stride=glob.stride)
        self._frame_idx = self._frame_idx + c
        return rows

    def step_chunk_packed(self, chunk: StreamFrame) -> torch.Tensor:
        """Track C ROI frames in one dispatch (one graph replay on the card)
        -> [C, 10] f32 rows on the device, a frame's packed TrackOutput a
        row (pack_track_output's layout); a copy, which later steps leave
        alone. chunk.track: stacked views, pixels [C, h, w, 3] and origins
        [C, 2]; chunk.glob: one global view, copied to the device only when
        it is not the tensor the last step read. Waits for nothing on the
        card."""
        return self._advance_chunk(chunk).clone()

    def step_chunk_device(self, chunk: StreamFrame) -> TrackOutput:
        """step_chunk_packed as a TrackOutput with a leading C axis."""
        return unpack_track_output(self.step_chunk_packed(chunk))

    def _read(self, row: torch.Tensor) -> np.ndarray:
        """The row on the host (on the card: one copy into pinned memory and
        one wait, a stream synchronize, which torch's sync debug mode counts)."""
        if self.device.type != "cuda":
            return row.numpy().copy()
        if self._row_buf is None:
            self._row_buf = torch.empty(row.shape, dtype=torch.float32).pin_memory()
        self._row_buf.copy_(row, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._row_buf.numpy().copy()

    def stage(self, frame) -> torch.Tensor:
        """A host array (a frame, a ROI crop or stack, origins) on its way to
        the device: on the card, copied into a pinned slot of `staging` (its
        copy to the device then needs no wait). A tensor passes through."""
        if isinstance(frame, torch.Tensor):
            return frame
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(frame))
        return self.staging.stage(frame)

    def _banks(self) -> int | None:
        return self._k_all if self._lead else None

    def step_device(self, frame_dev) -> TrackOutput:
        """Track one frame already on the device (or staged by ``stage``),
        or one StreamFrame, -> TrackOutput on the device (a copy of the
        step's output; [K, ...] for K banks). Waits for nothing on the card."""
        return unpack_track_output(self.step_packed(frame_dev), self._banks())

    def step_packed(self, frame_dev) -> torch.Tensor:
        """step_device with the output packed on the device into one f32
        row, [10] ([10 K] for K banks, pack_track_output's layout), packed
        inside the same graph; a copy, which later steps leave alone. A
        StreamFrame (one ROI frame) runs as a chunk of one, with its own
        graph."""
        if isinstance(frame_dev, StreamFrame):
            tv = frame_dev.track
            one = StreamFrame(FrameView(tv.pixels[None], tv.origin[None], tv.stride), frame_dev.glob)
            row = self.step_chunk_packed(one)[0]
            self.staging.copied(tv.pixels)  # staged slots: their copies are enqueued
            self.staging.copied(tv.origin)
            return row
        return self._all_banks(self._advance(frame_dev)).clone()

    def track_clip_device(self, frames_dev: torch.Tensor) -> TrackOutput:
        """Track a staged clip [T, ...] (a frame, or K frames, a step) on the
        device -> TrackOutput with a leading T axis, the same as T sequential
        steps: T replays, each row copied into a [T, 10 K] buffer on the
        device. Waits for nothing on the card."""
        rows = torch.empty((frames_dev.shape[0], 10 * self._k_all), dtype=torch.float32, device=self.device)
        for i in range(frames_dev.shape[0]):
            rows[i].copy_(self._all_banks(self._advance(frames_dev[i])))
        return unpack_track_output(rows, self._banks())


class Tracker(_GraphStepper):
    """User-facing API: Tracker(cfg).init(frame, bbox); .step(frame); .run(source);
    the device-side steps .step_device, .step_packed and .track_clip_device.

    device: "cuda" (default) or "cpu". Asking for CUDA without a card raises.
    One object, whatever runtime.banks says (as in the JAX package:
    runtime/banked.py's MultiTracker tracks K). Each step is a graph replay
    on the card (see _GraphStepper); ``step`` waits once a step in any
    config, for its record.

    mesh: a parallel.mesh.Mesh with a "bank" axis of 1, or None, when
    runtime.mesh_particles * mesh_model > 1 makes one (make_mesh over the
    default process group, NCCL on the card). Every rank of the mesh makes
    its Tracker and calls the same methods on the same inputs, and gets the
    same records.
    """

    def __init__(self, cfg: Config, vit_params=None, device="cuda", graphs: bool = True, mesh: Mesh | None = None):
        cfg.resolve()
        # runtime.mesh_particles / mesh_model shard the single-object
        # tracker over ranks: the particle axis over "particle", the ViT
        # tensor-parallel over "model" (parallel/mesh.py). mesh_banks belongs
        # to the banked tracker.
        r = cfg.runtime
        if r.mesh_banks > 1 or (mesh is not None and mesh.shape["bank"] > 1):
            raise ValueError("runtime.mesh_banks > 1 requires runtime.banks > 1 (the banked MultiTracker)")
        if mesh is None and r.mesh_particles * r.mesh_model > 1:
            mesh = make_mesh(1, r.mesh_particles, r.mesh_model, device=resolve_device(device))
        self._setup(cfg, vit_params, device, graphs, (), mesh)

    @_GraphStepper.state.setter
    def state(self, value: TrackerState) -> None:
        """Install a state (read back once for the host's copies)."""
        self._adopt(value, key_seed(value.key), int(value.frame_idx))

    def init(self, frame, bbox) -> None:
        """Template and cloud from the first frame; on the card, also the
        step's graph at this frame shape (captured now, so no capture lands
        inside a run)."""
        self._start(frame, bbox, int(self.cfg.filter.seed))

    def save(self, path: str) -> None:
        """Write the state (the whole state, as without a mesh; on a mesh
        rank 0 writes it, and every rank returns once it is written)."""
        if self._state is None:
            raise RuntimeError("nothing to save before init()")
        if self.mesh is None or self.mesh.rank == 0:
            save_tracker_state(path, self._state)
        if self.mesh is not None:
            torch.distributed.barrier()

    def resume(self, path: str) -> None:
        """Restore a saved state; later steps continue its trajectory. The seed
        and frame index are read from the file on the host."""
        self.state = load_tracker_state(path, "cpu")

    def step(self, frame) -> dict[str, Any]:
        """Track one frame; returns a host-side record (one wait for the card)."""
        t0 = time.perf_counter()
        rec = self._to_record(self._read(self._advance(self.stage(frame))))
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3
        return rec

    @staticmethod
    def _to_record(v: np.ndarray) -> dict[str, Any]:
        v = v.astype(np.float64)
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
