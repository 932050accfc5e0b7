"""Appearance likelihood: particle embeddings against the template — the
port of the JAX package's ``ops/likelihood.py``.

Two details that differ from PyTorch's defaults and matter for parity:
``l2_normalize`` puts eps outside the norm, x / (|x| + eps), and the z-norm
uses the population standard deviation (``torch.std`` defaults to the
sample one, ``correction=1``).

Every function takes optional leading axes (K filter banks); statistics are
taken over each bank's own particles. A template's leading axes are told by
``batch_dims``: a template [K, D] is K pooled templates with
batch_dims=1, and one per-cell template [C, D] with the default 0.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def l2_normalize_split(
    x: torch.Tensor, split: tuple[int, float] | None = None, eps: float = 1e-8
) -> torch.Tensor:
    """L2-normalize the last axis; with `split` = (d, b), each half on its own."""
    if split is None:
        return l2_normalize(x, eps=eps)
    d, _ = split
    return torch.cat([l2_normalize(x[..., :d], eps=eps), l2_normalize(x[..., d:], eps=eps)], dim=-1)


def _cos_to_template(
    embeddings: torch.Tensor,
    template: torch.Tensor,
    split: tuple[int, float] | None = None,
    batch_dims: int = 0,
) -> torch.Tensor:
    """Cosine of N embeddings to the template -> [..., N].

    template [..., D]: plain cosine. template [..., C, D] (per-cell
    L2-normalized): embeddings are [..., N, C, D] and the score is the mean
    per-cell cosine. The first `batch_dims` axes of the template are banks,
    each with its own N embeddings.
    """
    if split is not None:
        d, b = split
        cos_f = _cos_to_template(embeddings[..., :d], template[..., :d], batch_dims=batch_dims)
        cos_h = _cos_to_template(embeddings[..., d:], template[..., d:], batch_dims=batch_dims)
        return (1.0 - b) * cos_f + b * cos_h
    emb = l2_normalize(embeddings.float(), dim=-1)
    tmpl = template.float()
    if template.dim() - batch_dims == 1:
        return (emb @ tmpl[..., None])[..., 0]
    return torch.einsum("...ncd,...cd->...n", emb, tmpl) / template.shape[-2]


def cosine_log_likelihood(
    embeddings: torch.Tensor,
    template: torch.Tensor,
    temperature: float,
    split: tuple[int, float] | None = None,
    batch_dims: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (temperature * cos [..., N], cos [..., N])."""
    cos = _cos_to_template(embeddings, template, split, batch_dims)
    return temperature * cos, cos


def znormed_log_likelihood(
    embeddings: torch.Tensor,
    template: torch.Tensor,
    temperature: float,
    eps: float = 1e-6,
    mask: torch.Tensor | None = None,
    split: tuple[int, float] | None = None,
    batch_dims: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Self-normalizing likelihood: temperature * zscore_over_particles(cos)."""
    cos = _cos_to_template(embeddings, template, split, batch_dims)
    return znormed_logits_from_cos(cos, temperature, eps, mask), cos


def znormed_logits_from_cos(
    cos: torch.Tensor,
    temperature: float,
    eps: float = 1e-6,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """temperature * (cos - mu) / (sd + eps), with mu and the POPULATION sd
    taken over the valid (mask True) particles of each bank."""
    if mask is None:
        mu = cos.mean(dim=-1, keepdim=True)
        sd = torch.std(cos, dim=-1, correction=0, keepdim=True)
    else:
        m = mask.to(cos.dtype)
        count = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
        mu = torch.sum(cos * m, dim=-1, keepdim=True) / count
        var = torch.sum(torch.square(cos - mu) * m, dim=-1, keepdim=True) / count
        sd = torch.sqrt(var)
    z = (cos - mu) / (sd + eps)
    return temperature * z


def landscape_spread(
    cos: torch.Tensor,
    xy: torch.Tensor,
    top_frac: float,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Top-slice spatial spread of a cosine landscape [..., N] with points
    xy [..., N, 2] -> [...] (px)."""
    if mask is None:
        mask = torch.ones(cos.shape, dtype=torch.bool, device=cos.device)
    cmax = torch.amax(torch.where(mask, cos, float("-inf")), dim=-1, keepdim=True)
    cnt = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1)
    cmean = torch.sum(torch.where(mask, cos, torch.zeros_like(cos)), dim=-1, keepdim=True) / cnt
    thr = cmax - top_frac * torch.clamp(cmax - cmean, min=1e-6)
    w = torch.where(mask, torch.clamp(cos - thr, min=0.0), torch.zeros_like(cos))
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    mu = torch.sum(w[..., None] * xy, dim=-2)
    var = torch.sum(w * torch.sum(torch.square(xy - mu[..., None, :]), dim=-1), dim=-1)
    return torch.sqrt(var + 1e-12)


def auto_blend_target(
    spread: torch.Tensor, box_diag: torch.Tensor, lo: float, hi: float, b_min: float, b_max: float
) -> torch.Tensor:
    """Map trunk-landscape confusion to a per-step head blend -> [...]."""
    t = torch.clamp((spread / torch.clamp(box_diag, min=1e-6) - lo) / (hi - lo), 0.0, 1.0)
    return b_min + (b_max - b_min) * t


def center_embeddings(embeddings: torch.Tensor, mean_emb: torch.Tensor) -> torch.Tensor:
    """Subtract a context-mean embedding [..., D] from [..., M, D]."""
    return embeddings - mean_emb[..., None, :]
