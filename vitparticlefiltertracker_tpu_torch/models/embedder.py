"""Dense window appearance embedder — the port of the JAX package's
``models/embedder.py``.

One ViT forward on the search window per frame; every particle hypothesis
then reads its appearance from the token grid (ROI pooling), so all N
particles share that one forward. With the residual head the token features
are concat(trunk, head), and a score blends the two halves' cosines, each
half centered and normalized on its own. ``tiled_window_embed`` is global
re-detection's batch of tile windows through one forward. Centers, sides and
boxes take a leading bank axis (K filters, one window each): the K windows
go through one ViT forward at B = K.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.utils.checkpoint

from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec, vit_forward_tokens
from vitparticlefiltertracker_tpu_torch.ops.image import (
    FrameView,
    frame_to_window_coords,
    full_view,
    imagenet_stats,
    roi_cells_cos_mxu,
    roi_cells_mxu,
    roi_pool_cos_mxu,
    roi_pool_mxu,
    view_extract_window_mxu,
)


def _as_view(frame) -> FrameView:
    return frame if isinstance(frame, FrameView) else full_view(frame)


class DenseEmbedSpec(NamedTuple):
    """Static configuration of the dense appearance embedder."""

    vit: VitSpec  # resolved ViT spec (use_pos_embed False)
    s_img: int  # window resolution fed to the ViT
    patch: int  # ViT patch size
    appearance: str  # "pooled" | "cells"
    roi_grid: int  # KxK ROI-align samples per box
    center_features: bool  # subtract the window-mean embedding
    head_blend: float = 0.5

    @property
    def split(self) -> tuple[int, float] | None:
        if self.vit.head_depth > 0:
            return (self.vit.dim, self.head_blend)
        return None

    @classmethod
    def from_config(cls, cfg) -> "DenseEmbedSpec":
        spec = VitSpec.from_config(cfg.model)._replace(use_pos_embed=False)
        t = cfg.tracker
        return cls(
            vit=spec,
            s_img=cfg.model.image_size,
            patch=cfg.model.patch_size,
            appearance=t.appearance,
            roi_grid=t.roi_grid,
            center_features=t.center_features,
            head_blend=cfg.model.head_blend,
        )


def grid_tokens(feat: torch.Tensor, spec: VitSpec) -> torch.Tensor:
    """The encoder's output [B, T, D] -> the patch grid's tokens [B, g*g, D]:
    the prefix tokens (class token, registers) dropped after the final LN,
    the grid's row-major order kept."""
    return feat[:, spec.num_prefix:] if spec.num_prefix else feat


def normalize_window(window_raw: torch.Tensor) -> torch.Tensor:
    """Normalize an extracted uint8-valued float window (affine, so it
    commutes with the bilinear resample)."""
    mean, std = imagenet_stats(window_raw.dtype, window_raw.device)
    mean, std = mean * 255.0, std * 255.0
    return (window_raw - mean) / std


def make_dense_embedder(
    prm: dict,
    frame_f32,  # [H, W, 3] float (0..255 scale), [K, H, W, 3] (a frame a bank), or FrameView
    center: torch.Tensor,  # [..., 2] (x, y) search-window center, frame px
    side: torch.Tensor,  # [...] window side, frame px
    es: DenseEmbedSpec,
    *,
    remat: bool = False,
) -> Callable:
    """One ViT forward on the search window (on the K windows of centers
    [K, 2], at B = K); the returned pool() ROI-pools any number of box sets
    from the token grid, and pool.score() scores boxes against a template
    without forming their embeddings.

    pool(boxes_xy [..., M, 2], boxes_wh [..., M, 2])
        -> (emb [..., M, D] or [..., M, R*R, D], in_window [..., M])

    remat (training only): the window forward keeps no activation for the
    backward pass and is computed again there (torch.utils.checkpoint), as
    the JAX package's ``jax.checkpoint``: the trainer embeds four windows a
    scene pair, and their saved activations would dominate its memory.
    """
    spec = es.vit
    grid = es.s_img // es.patch
    lead = center.shape[:-1]
    window = normalize_window(view_extract_window_mxu(_as_view(frame_f32), center, side, es.s_img))
    window = window.reshape(-1, *window.shape[-3:])
    if remat:
        # The forward draws nothing random, so no RNG state is kept for the rerun.
        feat = torch.utils.checkpoint.checkpoint(vit_forward_tokens, prm, window, spec, use_reentrant=False,
                                                 preserve_rng_state=False)
    else:
        feat = vit_forward_tokens(prm, window, spec)
    feat = grid_tokens(feat, spec).reshape(*lead, grid, grid, spec.out_dim)
    mean_emb = feat.reshape(*lead, -1, spec.out_dim).mean(dim=-2)
    # Each window's center and side against its own boxes [..., M, 2].
    center, side = center[..., None, :], side[..., None, None]

    def pool(boxes_xy: torch.Tensor, boxes_wh: torch.Tensor):
        return pool_from_feat(feat, mean_emb, center, side, es, boxes_xy, boxes_wh)

    def score(tmpl: torch.Tensor, boxes_xy: torch.Tensor, boxes_wh: torch.Tensor):
        return score_from_feat(feat, mean_emb, center, side, es, tmpl, boxes_xy, boxes_wh)

    def score_halves(tmpl: torch.Tensor, boxes_xy: torch.Tensor, boxes_wh: torch.Tensor):
        return score_halves_from_feat(feat, mean_emb, center, side, es, tmpl, boxes_xy, boxes_wh)

    pool.score = score  # scores without forming the boxes' embeddings
    pool.score_halves = score_halves  # (cos_trunk, cos_head) for a per-step blend
    return pool


def _grid_boxes(center, side, es: DenseEmbedSpec, boxes_xy, boxes_wh):
    """Boxes in feature-grid coordinates plus the in-window mask."""
    s_img, patch = es.s_img, es.patch
    win_px = frame_to_window_coords(boxes_xy, center, side, s_img)
    gxy = (win_px - (patch - 1) / 2.0) / patch
    gwh = boxes_wh / side * s_img / patch
    in_win = torch.all((win_px >= 0) & (win_px <= s_img - 1), dim=-1)
    return gxy, gwh, in_win


def pool_from_feat(
    feat: torch.Tensor,  # [..., grid, grid, D]
    mean_emb: torch.Tensor,  # [..., D]
    center: torch.Tensor,  # [..., 1, 2] (or [2])
    side: torch.Tensor,
    es: DenseEmbedSpec,
    boxes_xy: torch.Tensor,  # [..., M, 2] frame px
    boxes_wh: torch.Tensor,  # [..., M, 2] frame px
):
    """ROI-pool per-box embeddings from a window feature grid ->
    ([..., M, K*K, D] or [..., M, D], in_win [..., M]). Leading axes batch
    windows, each with its own boxes (the tiled re-detection scan)."""
    gxy, gwh, in_win = _grid_boxes(center, side, es, boxes_xy, boxes_wh)
    if es.appearance == "cells":
        k = es.roi_grid
        emb = roi_cells_mxu(feat, gxy, gwh, k)  # [..., M, K, K, D]
        emb = emb.reshape(*emb.shape[:-3], k * k, feat.shape[-1])
    else:
        emb = roi_pool_mxu(feat, gxy, gwh, es.roi_grid)  # [..., M, D]
    if es.center_features:
        # Subtract each window's mean embedding from all of its boxes' rows.
        lead = mean_emb.shape[:-1]
        emb = emb - mean_emb.reshape(*lead, *([1] * (emb.dim() - len(lead) - 1)), -1)
    return emb, in_win


def _half_cosines(feat, mean_emb, es: DenseEmbedSpec, tmpl, gxy, gwh):
    """The fused scorer on the trunk half and on the head half, each
    centered and normalized on its own -> (cos_trunk [M], cos_head [M])."""
    fused = roi_cells_cos_mxu if es.appearance == "cells" else roi_pool_cos_mxu
    d, _ = es.split
    mean_f = mean_emb[..., :d] if es.center_features else None
    mean_h = mean_emb[..., d:] if es.center_features else None
    cos_f = fused(feat[..., :d], mean_f, tmpl[..., :d], gxy, gwh, es.roi_grid)
    cos_h = fused(feat[..., d:], mean_h, tmpl[..., d:], gxy, gwh, es.roi_grid)
    return cos_f, cos_h


def score_from_feat(
    feat: torch.Tensor,
    mean_emb: torch.Tensor,
    center: torch.Tensor,
    side: torch.Tensor,
    es: DenseEmbedSpec,
    tmpl: torch.Tensor,  # [K*K, D] (cells) or [D] (pooled), L2-normalized
    boxes_xy: torch.Tensor,
    boxes_wh: torch.Tensor,
):
    """Fused template cosine scores for M boxes -> (cos [M], in_win [M]).
    With the head, (1 - b) * cos_trunk + b * cos_head at the static blend."""
    gxy, gwh, in_win = _grid_boxes(center, side, es, boxes_xy, boxes_wh)
    if es.split is not None:
        cos_f, cos_h = _half_cosines(feat, mean_emb, es, tmpl, gxy, gwh)
        b = es.split[1]
        return (1.0 - b) * cos_f + b * cos_h, in_win
    fused = roi_cells_cos_mxu if es.appearance == "cells" else roi_pool_cos_mxu
    mean = mean_emb if es.center_features else None
    return fused(feat, mean, tmpl, gxy, gwh, es.roi_grid), in_win


def score_halves_from_feat(
    feat: torch.Tensor,
    mean_emb: torch.Tensor,
    center: torch.Tensor,
    side: torch.Tensor,
    es: DenseEmbedSpec,
    tmpl: torch.Tensor,
    boxes_xy: torch.Tensor,
    boxes_wh: torch.Tensor,
):
    """score_from_feat's two halves unblended -> (cos_trunk [M], cos_head
    [M], in_win [M]), for a blend chosen per step. Needs the head."""
    if es.split is None:
        raise ValueError("score_halves_from_feat needs the residual head (model.head_depth > 0)")
    gxy, gwh, in_win = _grid_boxes(center, side, es, boxes_xy, boxes_wh)
    return (*_half_cosines(feat, mean_emb, es, tmpl, gxy, gwh), in_win)


def tiled_window_embed(
    prm: dict,
    frame_f32,  # [H, W, 3] float frame ([K, H, W, 3]: a frame a bank) or FrameView
    tile_ctrs: torch.Tensor,  # [..., G, 2] tile window centers, frame px
    tile_side: torch.Tensor,  # [...] tile window side, frame px
    es: DenseEmbedSpec,
    cand_xy: torch.Tensor,  # [..., G, C, 2] candidate box centers per tile, frame px
    cand_wh: torch.Tensor,  # [..., 2] candidate box size, frame px
):
    """Embed C candidate boxes in each of G tile windows with one batched
    ViT forward (global re-detection; K banks' tiles in one forward at
    B = K*G): each tile is a window at about the local search's scale, so
    candidates are scored at the resolution the appearance model tracks at.
    -> (emb [..., G, C, ...], valid [..., G, C])."""
    spec = es.vit
    grid = es.s_img // es.patch
    lead = tile_ctrs.shape[:-1]
    windows = normalize_window(view_extract_window_mxu(_as_view(frame_f32), tile_ctrs, tile_side, es.s_img))
    feats = vit_forward_tokens(prm, windows.reshape(-1, *windows.shape[-3:]), spec)  # [K*G, T, out_dim]
    feats = grid_tokens(feats, spec).reshape(*lead, grid, grid, spec.out_dim)
    mean_embs = feats.mean(dim=(-3, -2))  # [..., G, out_dim]
    wh = cand_wh[..., None, None, :].expand(cand_xy.shape)
    side = tile_side.reshape(*tile_side.shape, 1, 1, 1)
    return pool_from_feat(feats, mean_embs, tile_ctrs[..., None, :], side, es, cand_xy, wh)
