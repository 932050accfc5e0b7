"""The feature-training loop — the port of the JAX package's
``training/train.py``.

One train step draws a scene batch on the device (training/data.py) from a
generator keyed on (train.seed, step), runs the localization InfoNCE
(training/objective.py) through the tracker's dense embedder with bf16 (or
f32) compute over f32 master weights, and applies AdamW with optax's rules:
a warmup-cosine schedule, a global-norm clip at 1.0, and weight decay on
the matmul kernels only. The step reads nothing back: the loop reads the
metrics only where it logs or probes, so the card runs the steps between
without waiting for the host.

Freezing (the residual head's trunk, or train.freeze_prefix blocks) holds
the frozen weights byte for byte: a frozen whole leaf does not require
grad; frozen slices of the depth-stacked blocks get a zero gradient before
the clip and their values back after AdamW's decoupled decay.

Checkpoints are written with models/params.py in the repo's npz format, so
``model.checkpoint: <path>`` in any tracker config (either package's) reads
them. The JAX package's data-parallel mesh is not ported (one card).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import torch

from vitparticlefiltertracker_tpu_torch.filters.particle import make_generator
from vitparticlefiltertracker_tpu_torch.models.embedder import DenseEmbedSpec
from vitparticlefiltertracker_tpu_torch.models.params import (
    _flatten,
    _map,
    init_vit_params,
    load_params,
    save_params,
    trunk_key,
)
from vitparticlefiltertracker_tpu_torch.ops.image import imagenet_stats
from vitparticlefiltertracker_tpu_torch.training.data import make_pair_batch
from vitparticlefiltertracker_tpu_torch.training.objective import batch_loss, ring_offsets
from vitparticlefiltertracker_tpu_torch.utils.platform import resolve_device

_DECAY_LEAVES = {"wqkv", "wo", "w1", "w2", "kernel"}  # matmul weights only
MAX_GRAD_NORM = 1.0
BETAS = (0.9, 0.999)  # optax.adamw's defaults
EPS = 1e-8
DATA_STREAM_XOR = 0x7A11  # the step generator's seed is train.seed ^ this (the JAX package's data key)


def _decay_mask(params) -> dict:
    """AdamW decay on matmul kernels only (biases, LN, pos-embed excluded)."""
    return {k: _decay_mask(v) if isinstance(v, dict) else k in _DECAY_LEAVES for k, v in params.items()}


def lr_schedule(tr):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup
    + 1), 0.05 lr) as a function of the 0-based update count: a linear ramp
    from 0 (the first update's rate is 0), then a cosine down to 5 %."""
    peak, warm = tr.lr, tr.warmup
    span = max(tr.steps, warm + 1) - warm
    end = peak * 0.05
    alpha = end / peak if peak else 0.0

    def lr(count: int) -> float:
        if count < warm:
            return (0.0 - peak) * (1.0 - count / warm) + peak
        t = min(count - warm, span)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / span)) + alpha)

    return lr


class TrainOptimizer:
    """optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay,
    mask=_decay_mask)) over the leaves that require grad: torch's AdamW with
    a decay and a no-decay group, optax's betas and eps; the rate set from
    the schedule at the optimizer's own update count (a host int, as optax
    counts); the clip as tensor ops (scale by max_norm / norm only where
    norm >= max_norm, optax's rule), so an update waits for nothing.
    `pinned`: leaf name -> first n depth slices held fixed (freeze_prefix)."""

    def __init__(self, params: dict, tr, pinned_depth: int = 0):
        self.leaves = {k: v for k, v in _flatten(params).items() if v.requires_grad}
        decay = [v for k, v in self.leaves.items() if k.rsplit("/", 1)[-1] in _DECAY_LEAVES]
        rest = [v for k, v in self.leaves.items() if k.rsplit("/", 1)[-1] not in _DECAY_LEAVES]
        groups = [g for g in ({"params": decay, "weight_decay": tr.weight_decay},
                              {"params": rest, "weight_decay": 0.0}) if g["params"]]
        self.adamw = torch.optim.AdamW(groups, lr=0.0, betas=BETAS, eps=EPS)
        self.lr = lr_schedule(tr)
        self.count = 0
        self.pinned = {k: v[:pinned_depth].detach().clone()
                       for k, v in self.leaves.items() if pinned_depth and k.startswith("blocks/")}

    def update(self, grads: dict) -> torch.Tensor:
        """Apply one update from `grads` (leaf name -> gradient, frozen parts
        already zero) in place -> the gradients' global norm (before the clip)."""
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
            keep = norm < MAX_GRAD_NORM
            for k, p in self.leaves.items():
                g = grads[k]
                p.grad = torch.where(keep, g, g / norm * MAX_GRAD_NORM)
            for group in self.adamw.param_groups:
                group["lr"] = self.lr(self.count)
            self.adamw.step()
            self.adamw.zero_grad(set_to_none=True)
            for k, fixed in self.pinned.items():
                self.leaves[k][: fixed.shape[0]].copy_(fixed)  # undo the decay of frozen slices
        self.count += 1
        return norm


def _train_embed_spec(cfg) -> DenseEmbedSpec:
    """The tracker's embedder spec with the training overrides: the training
    window (0 = the model's), the plain differentiable attention (K1 has no
    backward), and the training compute dtype."""
    tr = cfg.train
    es = DenseEmbedSpec.from_config(cfg)
    window = tr.window or es.s_img
    vit = es.vit._replace(image_size=window, use_flash_attention=False,
                          dtype=torch.bfloat16 if tr.dtype == "bfloat16" else torch.float32)
    return es._replace(vit=vit, s_img=window)


def _freeze_plan(cfg, depth: int):
    """(is the leaf of this name trained, depth slices of the blocks pinned).

    With the residual head (model.head_depth > 0) only params["head"] trains:
    the trunk is the seeded random init the blended score's first half
    rides on. train.freeze_prefix n > 0 pins patch_embed, pos_embed and the
    first n stacked blocks."""
    if cfg.model.head_depth > 0:
        return (lambda name: name.startswith("head/")), 0
    n = cfg.train.freeze_prefix
    if n <= 0:
        return (lambda name: True), 0
    if n >= depth:
        raise ValueError(f"train.freeze_prefix {n} must be < model depth {depth}")
    return (lambda name: not name.startswith(("patch_embed/", "pos_embed"))), n


def build_train_step(cfg, device="cuda"):
    """-> (init_fn, step_fn) on `device` (the card unless "cpu").

    init_fn(params=None) -> (params, opt): f32 master weights (the JAX
        package's random init from filter.seed ^ 0x5EED, bit for bit, or a
        copy of the given tree), the trained leaves requiring grad, and a
        TrainOptimizer over them.
    step_fn(params, opt, step, batch=None, draws=None) -> (params, opt,
        metrics): one update in place; metrics are 0-d tensors on the
        device (the loss terms' means, loss, grad_norm). The scene batch and
        the loss draws come from the step's generator, keyed on
        (train.seed ^ 0x7A11, step), unless given.
    step_fn.grads(params, step, batch=None, draws=None) -> (loss, metrics,
        grads): the step without the update; grads by leaf name, frozen
        parts zero.
    """
    tr = cfg.train
    dev = torch.empty(0, device=resolve_device(device)).device
    es = _train_embed_spec(cfg)
    trained, pinned_depth = _freeze_plan(cfg, es.vit.depth)
    kw = dict(
        tau=tr.tau,
        search_scale=cfg.tracker.search_scale,
        num_random=tr.num_random_negatives,
        template_jitter=tr.template_jitter,
        cloud_weight=tr.cloud_weight,
        cloud_particles=tr.cloud_particles,
        cloud_sigma=tr.cloud_sigma,
        cloud_zscale=tr.cloud_zscale,
        distractor_margin=tr.distractor_margin,
        distractor_weight=tr.distractor_weight,
        distractor_centered_weight=tr.distractor_centered_weight,
        distractor_absent_weight=tr.distractor_absent_weight,
    )
    # The objective's constants, made now: a copy from host memory inside a
    # step would be a wait for the card.
    ring_offsets(dev)
    imagenet_stats(torch.float32, dev)

    def init_fn(params: dict | None = None):
        if params is None:
            params = init_vit_params(trunk_key(cfg.filter.seed), es.vit, dev)
        params = _map(params, lambda x: x.detach().to(dev, torch.float32, copy=True))
        for name, leaf in _flatten(params).items():
            leaf.requires_grad_(trained(name))
        return params, TrainOptimizer(params, tr, pinned_depth)

    def grad_fn(params, step: int, batch=None, draws=None):
        gen = make_generator(tr.seed ^ DATA_STREAM_XOR, step, dev)
        if batch is None:
            batch = make_pair_batch(gen, tr.batch_size, tr.canvas, tr.lookalike_frac, tr.blur_prob, tr.blur_sigma)
        loss, metrics = batch_loss(params, es, batch, draws, gen, **kw)
        leaves = {k: v for k, v in _flatten(params).items() if v.requires_grad}
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {}
        for (k, v), g in zip(leaves.items(), got):
            g = torch.zeros_like(v) if g is None else g
            if pinned_depth and k.startswith("blocks/"):
                g[:pinned_depth] = 0.0
            grads[k] = g
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step_fn(params, opt: TrainOptimizer, step: int, batch=None, draws=None):
        loss, metrics, grads = grad_fn(params, step, batch, draws)
        norm = opt.update(grads)
        return params, opt, dict(metrics, loss=loss, grad_norm=norm)

    step_fn.grads = grad_fn
    return init_fn, step_fn


def _to_host(params: dict) -> dict:
    return _map(params, lambda x: x.detach().to("cpu", copy=True))


def train_features(cfg, log=None, device="cuda") -> dict:
    """Run the training loop on `device`; returns the trained parameter
    tree (the probe's best, when train.eval_every > 0).

    Writes the checkpoint to train.checkpoint_out (a head-only file when the
    residual head trained on the seeded trunk) and one JSON line of metrics
    a log interval to train.metrics_out (and to `log`, stderr by default)."""
    tr = cfg.train
    if log is None:
        log = lambda s: print(s, file=sys.stderr)  # noqa: E731
    dev = torch.empty(0, device=resolve_device(device)).device
    init_fn, step_fn = build_train_step(cfg, dev)

    probe = None
    if tr.eval_every > 0:
        from vitparticlefiltertracker_tpu_torch.training.probe import make_probe

        probe = make_probe(cfg, clips=tuple(tr.eval_clips), frames=tr.eval_frames,
                           num_particles=tr.eval_particles, device=dev)
    best = {"rmse": float("inf"), "params": None, "step": 0}

    params, opt = init_fn()
    # model.checkpoint: start from those weights (continue a run, or train
    # the head on a loaded trunk), cast to f32 masters; a head-only file's
    # trunk is regenerated; a fresh head is kept where the file has none.
    trunk_from_seed = True
    if cfg.model.checkpoint:
        ck = load_params(cfg.model.checkpoint, dev)
        ck_seed = ck.pop("__trunk_seed__", None)
        if ck_seed is not None:
            vit = _train_embed_spec(cfg).vit._replace(head_depth=0)
            ck = dict(init_vit_params(trunk_key(ck_seed), vit, dev), head=ck["head"])
        if cfg.model.head_depth > 0 and "head" not in ck:
            ck["head"] = params["head"]
        params, opt = init_fn(ck)
        # A head-only save stays valid only if the trunk is the seeded init
        # this config regenerates at load.
        trunk_from_seed = ck_seed is not None and int(ck_seed) == cfg.filter.seed
        log(f"initialized from {cfg.model.checkpoint}"
            + (" (head-only: trunk regenerated)" if ck_seed is not None else ""))

    def run_probe(step_i: int) -> dict:
        pm = probe(params)
        if pm["probe_rmse"] < best["rmse"]:
            best.update(rmse=pm["probe_rmse"], params=_to_host(params), step=step_i)
        return pm

    if probe is not None:
        # The step-0 probe: the starting weights under the same settings,
        # logged only (never selected).
        log(json.dumps({k: round(v, 2) for k, v in probe(params).items()} | {"step": 0}))
    if tr.metrics_out:
        os.makedirs(os.path.dirname(tr.metrics_out) or ".", exist_ok=True)
    metrics_f = open(tr.metrics_out, "w") if tr.metrics_out else None
    t0 = time.perf_counter()
    try:
        for i in range(tr.steps):
            params, opt, metrics = step_fn(params, opt, i)
            logging = (i + 1) % tr.log_every == 0 or i + 1 == tr.steps
            probing = probe is not None and ((i + 1) % tr.eval_every == 0 or i + 1 == tr.steps)
            if logging or probing:
                # The loop's only reads from the card; keys sorted, as the
                # JAX package's jitted step returns them.
                m = {k: float(v) for k, v in sorted(metrics.items())}
                if probing:
                    m.update({k: round(v, 2) for k, v in run_probe(i + 1).items()})
                m["step"] = i + 1
                m["wall_s"] = round(time.perf_counter() - t0, 2)
                line = json.dumps(m)
                log(line)
                if metrics_f:
                    metrics_f.write(line + "\n")
                    metrics_f.flush()
    finally:
        if metrics_f:
            metrics_f.close()
        # Saved in `finally`: an interrupted run keeps its probe-selected best.
        if best["params"] is not None:
            log(f"checkpoint selection: step {best['step']} (probe_rmse {best['rmse']:.2f}px) of {tr.steps}")
            params = best["params"]
        if tr.checkpoint_out:
            os.makedirs(os.path.dirname(tr.checkpoint_out) or ".", exist_ok=True)
            to_save = _to_host(params)
            if tr.checkpoint_dtype == "bfloat16":
                to_save = _map(to_save, lambda x: x.to(torch.bfloat16))
            # Head training: the trunk is the frozen seeded init, so only the
            # head and the seed are stored (checkpoint_dtype quantizes the
            # head only; the trunk is regenerated in f32). A loaded,
            # non-seeded trunk must be stored whole.
            if cfg.model.head_depth > 0 and trunk_from_seed:
                save_params(tr.checkpoint_out, to_save, trunk_seed=cfg.filter.seed)
            else:
                save_params(tr.checkpoint_out, to_save)
            log(f"saved {tr.checkpoint_out}")
    return params
