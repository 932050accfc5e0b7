"""Localization InfoNCE: teach the dense embedder to rank the true box first
— the port of the JAX package's ``training/objective.py``.

For each scene pair the template is pooled from frame0 at the (jittered)
true box, as Tracker.init builds it, and scored against M candidate boxes in
frame1: the true box, a ring of hard offset negatives, random window boxes,
the distractor and its ring, and a particle-like cloud. Softmax
cross-entropy with the true box as label 0, ratio hinges that push the
distractor's cosine landscape below a margin of the true match (in the
shared window, in a window centred on the distractor, and with the target
absent), and the posterior-mean error of the cloud weighted as the tracker
weights it.

The embedding path is the tracker's own (models/embedder.py): window
extraction, ROI cells, window-mean centering and per-cell normalization are
all differentiated through. The JAX package computes one pair and vmaps it
over the batch; here every term runs batched over B, and the B windows of a
term go through one ViT forward. The per-pair random draws are arguments
(``LossDraws``), so the tests can feed the JAX package's.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from vitparticlefiltertracker_tpu_torch.models.embedder import DenseEmbedSpec, make_dense_embedder
from vitparticlefiltertracker_tpu_torch.ops.likelihood import _cos_to_template, l2_normalize_split
from vitparticlefiltertracker_tpu_torch.training.data import SceneBatch

N_DRING = 16  # the distractor's ring: the offsets at radii 0.3 and 0.55, 8 directions each


@functools.lru_cache(maxsize=None)
def ring_offsets(device: torch.device | str = "cpu") -> torch.Tensor:
    """Hard-negative offsets in units of the box size, [40, 2]: 8 directions
    x radii 0.3, 0.55, 1.0, 1.75 and 3.0 (the overlapping radii sharpen the
    cosine peak in position; 1.0 is the adjacent box). Built once a device:
    callers must not write to it."""
    ang = torch.arange(8, dtype=torch.float32) * (2 * math.pi / 8)
    dirs = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)  # [8, 2]
    radii = torch.tensor([0.3, 0.55, 1.0, 1.75, 3.0], dtype=torch.float32)
    return (radii[:, None, None] * dirs[None]).reshape(-1, 2).to(device)


class LossDraws(NamedTuple):
    """A batch's random draws in the objective, as the JAX package's
    pair_loss makes them from its key."""

    jitter: torch.Tensor  # [B, 2] standard normal: the template box's jitter
    rand: torch.Tensor  # [B, num_random, 2] uniform(-0.4, 0.4): random boxes, in window sides
    cloud: torch.Tensor  # [B, n_cloud, 2] standard normal: the cloud around the truth


def draw_loss(gen: torch.Generator, batch: int, num_random: int, n_cloud: int) -> LossDraws:
    dev = gen.device
    jitter = torch.randn((batch, 2), generator=gen, device=dev)
    rand = torch.rand((batch, num_random, 2), generator=gen, device=dev) * 0.8 - 0.4
    cloud = torch.randn((batch, n_cloud, 2), generator=gen, device=dev)
    return LossDraws(jitter, rand, cloud)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with jnp.maximum's gradient (half each way on a tie)."""
    return torch.maximum(x, torch.zeros_like(x))


def batch_loss(
    prm: dict,
    es: DenseEmbedSpec,
    batch: SceneBatch,
    draws: LossDraws | None = None,
    gen: torch.Generator | None = None,
    *,
    tau: float,
    search_scale: float,
    num_random: int,
    template_jitter: float,
    cloud_weight: float = 0.0,
    cloud_particles: int = 64,
    cloud_sigma: float = 8.0,
    cloud_zscale: float = 9.0,
    distractor_margin: float = 0.0,
    distractor_weight: float = 0.0,
    distractor_centered_weight: float = 0.0,
    distractor_absent_weight: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """Mean loss over a SceneBatch -> (loss, metric means), each a 0-d
    tensor. The draws come from `gen` unless given."""
    b = batch.p0.shape[0]
    n_cloud = cloud_particles if cloud_weight > 0.0 else 0
    if draws is None:
        draws = draw_loss(gen, b, num_random, n_cloud)
    p0, p1, wh, d1 = batch.p0, batch.p1, batch.wh, batch.d1
    # The window side as the tracker computes it, floored so small targets
    # still see their motion range.
    side = torch.clamp(search_scale * torch.sqrt(wh[:, 0] * wh[:, 1]), min=64.0)

    def window(frame, center):
        return make_dense_embedder(prm, frame, center, side, es, remat=True)

    # The template from frame0 at the true box, jittered as the tracker's
    # estimates jitter the boxes its template EMA sees.
    t_xy = p0 + template_jitter * wh * draws.jitter
    emb0, _ = window(batch.frame0, p0)(t_xy[:, None], wh[:, None])
    split = es.split
    tmpl = l2_normalize_split(emb0[:, 0].float(), split)
    head_split = (split[0], 1.0) if split is not None else None

    def cosines(emb):
        """(blended cos [B, M], the head half's or None)."""
        c = _cos_to_template(emb, tmpl, split, batch_dims=1)
        return c, (_cos_to_template(emb, tmpl, head_split, batch_dims=1) if head_split is not None else None)

    # Candidates in frame1, the window centred on p0: the tracker's step geometry.
    offs = ring_offsets(p0.device) * wh[:, None, :]  # [B, 40, 2]
    rand = p0[:, None, :] + side[:, None, None] * draws.rand
    cloud = p1[:, None, :] + cloud_sigma * draws.cloud
    d_ring = d1[:, None, :] + offs[:, :N_DRING]
    cand = torch.cat([p1[:, None], p1[:, None] + offs, rand, d1[:, None], d_ring, cloud], dim=1)  # [B, M, 2]
    emb1, valid = window(batch.frame1, p0)(cand, wh[:, None, :].expand(cand.shape))
    cos, cos_head = cosines(emb1)
    n_rank = 1 + offs.shape[1] + num_random + 1
    i_cloud = n_rank + N_DRING

    def ratio_hinge(c, c_h, ok, ref, ref_h):
        """max(0, peak over the valid boxes - margin * ref), the blended
        score's plus the head half's -> [B]."""
        peak = torch.where(ok, c, -1.0).amax(dim=-1)
        v = _relu(peak - distractor_margin * ref.detach())
        if c_h is not None:
            peak_h = torch.where(ok, c_h, -1.0).amax(dim=-1)
            v = v + _relu(peak_h - distractor_margin * ref_h.detach())
        return torch.where(ok.any(dim=-1), v, 0.0)

    def head_at(c_h, i):
        return c_h[:, i] if c_h is not None else None

    def head_slice(c_h, sl):
        return c_h[:, sl] if c_h is not None else None

    rank = torch.arange(n_rank, device=cos.device)
    logits = cos[:, :n_rank] / tau
    # Out-of-window negatives drop out of the softmax; the true box stays.
    logits = torch.where(valid[:, :n_rank] | (rank == 0), logits, -1e9)
    loss = -torch.log_softmax(logits, dim=-1)[:, 0]
    metrics = {
        "acc": (torch.argmax(logits, dim=-1) == 0).float(),
        "cos_pos": cos[:, 0],
        "cos_neg_max": torch.where(valid[:, :n_rank], cos[:, :n_rank], -1.0)[:, 1:].amax(dim=-1),
        "cos_distractor": torch.where(valid[:, n_rank - 1], cos[:, n_rank - 1], 0.0),
        "distractor_valid": valid[:, n_rank - 1].float(),
    }

    if distractor_weight > 0.0:
        # The distractor's cosine landscape (the box and its ring) below
        # margin x the true match's, in the shared window.
        sl = slice(n_rank - 1, i_cloud)
        loss = loss + distractor_weight * ratio_hinge(cos[:, sl], head_slice(cos_head, sl), valid[:, sl], cos[:, 0],
                                                      head_at(cos_head, 0))

    if distractor_centered_weight > 0.0:
        # A window centred on the distractor (the tracker drifted onto it):
        # hinge its landscape there, and rank the true box above it.
        cand_d = torch.cat([d1[:, None], d_ring, p1[:, None]], dim=1)
        embd, validd = window(batch.frame1, d1)(cand_d, wh[:, None, :].expand(cand_d.shape))
        cos_d, cos_d_h = cosines(embd)
        i_true = N_DRING + 1
        viol_c = ratio_hinge(cos_d[:, :i_true], head_slice(cos_d_h, slice(None, i_true)), validd[:, :i_true],
                             cos[:, 0], head_at(cos_head, 0))
        is_true = torch.arange(N_DRING + 2, device=cos.device) == i_true
        logits_d = torch.where(validd | is_true, cos_d / tau, -1e9)
        rank_c = -torch.log_softmax(logits_d, dim=-1)[:, i_true]
        loss = loss + distractor_centered_weight * (viol_c + torch.where(validd[:, i_true], rank_c, 0.0))
        metrics["cos_dc_clone"] = cos_d[:, 0]
        # Lookalike-subset telemetry: mean(value * look_on) / mean(look_on).
        metrics["cos_dc_clone_look"] = cos_d[:, 0] * batch.look_on
        metrics["cos_dc_true_look"] = cos_d[:, i_true] * batch.look_on
        metrics["look_frac"] = batch.look_on

    if distractor_absent_weight > 0.0:
        # The target-absent context (an occlusion): frame2, centred on the
        # distractor; hinge its landscape, nothing to rank.
        cand_a = torch.cat([d1[:, None], d_ring], dim=1)
        emba, valida = window(batch.frame2, d1)(cand_a, wh[:, None, :].expand(cand_a.shape))
        cos_a, cos_a_h = cosines(emba)
        da_peak = torch.where(valida, cos_a, -1.0).amax(dim=-1)
        loss = loss + distractor_absent_weight * ratio_hinge(cos_a, cos_a_h, valida, cos[:, 0],
                                                             head_at(cos_head, 0))
        metrics["cos_da_peak"] = da_peak
        metrics["cos_da_peak_look"] = da_peak * batch.look_on

    if n_cloud:
        # The posterior mean's expected squared error over a particle-like
        # cloud weighted as the tracker weights it (zcos: softmax of zscale x
        # the z-score over the cloud), normalized by the prior spread.
        c_cos, c_valid = cos[:, i_cloud:], valid[:, i_cloud:]
        nv = torch.clamp(c_valid.sum(dim=-1), min=1)
        mu = torch.where(c_valid, c_cos, 0.0).sum(dim=-1) / nv
        var = torch.where(c_valid, (c_cos - mu[:, None]) ** 2, 0.0).sum(dim=-1) / nv
        z = (c_cos - mu[:, None]) * torch.rsqrt(var + 1e-6)[:, None]
        w = torch.softmax(torch.where(c_valid, cloud_zscale * z, -1e9), dim=-1)
        err2 = torch.sum((cloud - p1[:, None, :]) ** 2, dim=-1)  # [B, n_cloud] px^2
        cloud_err2 = torch.sum(w * err2, dim=-1)
        loss = loss + cloud_weight * cloud_err2 / (2.0 * cloud_sigma**2)
        metrics["cloud_px"] = torch.sqrt(cloud_err2)
    return loss.mean(), {k: v.mean() for k, v in metrics.items()}
