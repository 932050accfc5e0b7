"""Typed config schema and loader — the port's own copy of the JAX package's
``config.py``, so one ``config.yaml`` drives both packages with the same keys
and the same validation.

``yaml`` is imported only inside the functions that parse YAML text
(``load_config``, ``apply_override``, ``Config.to_yaml``): a program that
builds its config with ``Config.from_dict`` needs no YAML parser at all.

CLI overrides use dotted paths: ``--set filter.num_particles=4096``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

# ViT presets. Every preset has head dim 64, the one width the attention
# kernel (csrc/flash_attn.cu) takes. dinov2-g14-reg is DINOv2 ViT-g/14 with
# registers (Oquab et al., arXiv:2304.07193; Darcet et al., arXiv:2309.16588):
# a SwiGLU FFN of hidden width mlp_dim and the class token and 4 registers
# ahead of the patches. Its LayerScale gammas are leaves of the weights
# (models/vit.py), not a key.
VIT_PRESETS: dict[str, dict[str, Any]] = {
    "vit-t16": dict(depth=4, dim=192, heads=3, mlp_dim=768, patch_size=16),
    "vit-s16": dict(depth=12, dim=384, heads=6, mlp_dim=1536, patch_size=16),
    "vit-b16": dict(depth=12, dim=768, heads=12, mlp_dim=3072, patch_size=16),
    "vit-l16": dict(depth=24, dim=1024, heads=16, mlp_dim=4096, patch_size=16),
    "dinov2-g14-reg": dict(depth=40, dim=1536, heads=24, mlp_dim=4096, patch_size=14, ffn="swiglu", registers=4,
                           drop_cls_token=False),
}
# The model keys of the port alone (the JAX package's schema has none of
# them), at their defaults: a config file of the JAX package runs the plain
# GELU ViT.
PORT_MODEL_DEFAULTS: dict[str, Any] = {"ffn": "gelu", "registers": 0}


@dataclass
class ModelConfig:
    """ViT appearance-model hyperparameters."""

    variant: str = "vit-b16"  # preset name or "custom"
    # Filled from the preset unless variant == "custom".
    depth: int = 12
    dim: int = 768
    heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 224  # search-window resolution fed to the ViT
    pooling: str = "mean"  # "mean" | "cls"
    dtype: str = "bfloat16"  # compute dtype: "bfloat16" | "float32"
    use_flash_attention: bool = True  # kept for config compatibility
    checkpoint: str = ""  # .npz weights; "" = random init from filter.seed
    drop_cls_token: bool = True
    ln_eps: float = 1e-6
    scan_unroll: int = 0  # JAX layer-loop lowering; no meaning in the port
    # Residual discriminative head: head_depth extra blocks; scores blend the
    # trunk and head halves' cosines at head_blend (or, with head_blend_auto,
    # the likelihood at a per-step blend).
    head_depth: int = 0
    head_blend: float = 0.5
    head_blend_auto: bool = False
    head_blend_min: float = 0.15
    head_blend_max: float = 0.6
    head_blend_ema: float = 0.25
    head_blend_spread_lo: float = 0.25
    head_blend_spread_hi: float = 1.0
    head_blend_top_frac: float = 0.35
    # The block and the prefix (the port's alone; PORT_MODEL_DEFAULTS):
    # ffn "gelu" (w1, exact GELU, w2) or "swiglu" (w12 to 2 mlp_dim columns,
    # silu(gate) * up, w3); registers: tokens after the class token and
    # ahead of the patches, with no position embedding. The dense features
    # are the patch tokens alone.
    ffn: str = "gelu"
    registers: int = 0

    def resolve(self) -> "ModelConfig":
        if self.variant != "custom":
            if self.variant not in VIT_PRESETS:
                raise ValueError(
                    f"unknown model.variant {self.variant!r}; "
                    f"expected one of {sorted(VIT_PRESETS)} or 'custom'"
                )
            for k, v in VIT_PRESETS[self.variant].items():
                setattr(self, k, v)
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"model.image_size {self.image_size} must be divisible by "
                f"patch_size {self.patch_size}"
            )
        if self.dim % self.heads != 0:
            raise ValueError("model.dim must be divisible by model.heads")
        if self.pooling not in ("mean", "cls"):
            raise ValueError("model.pooling must be 'mean' or 'cls'")
        if self.ffn not in ("gelu", "swiglu"):
            raise ValueError("model.ffn must be 'gelu' or 'swiglu'")
        if self.registers < 0:
            raise ValueError("model.registers must be >= 0")
        if self.head_depth < 0:
            raise ValueError("model.head_depth must be >= 0")
        if not 0.0 <= self.head_blend <= 1.0:
            raise ValueError("model.head_blend must be in [0, 1]")
        if self.head_blend_auto:
            if self.head_depth <= 0:
                raise ValueError(
                    "model.head_blend_auto requires model.head_depth > 0 "
                    "(there is no second feature half to blend without a head)"
                )
            if not 0.0 <= self.head_blend_min <= self.head_blend_max <= 1.0:
                raise ValueError(
                    "model.head_blend_min/max must satisfy 0 <= min <= max <= 1"
                )
            if not 0.0 < self.head_blend_ema <= 1.0:
                raise ValueError("model.head_blend_ema must be in (0, 1]")
            if not self.head_blend_spread_lo < self.head_blend_spread_hi:
                raise ValueError(
                    "model.head_blend_spread_lo must be < head_blend_spread_hi"
                )
        if self.head_blend == 0.0:
            # blend 0 disables the head structurally, as in the JAX package.
            self.head_depth = 0
        return self


@dataclass
class MotionConfig:
    """Gaussian constant-velocity motion model."""

    sigma_pos: float = 6.0
    sigma_vel: float = 1.5
    sigma_scale: float = 0.0
    vel_decay: float = 0.95


@dataclass
class FilterConfig:
    """Particle filter (SIR) parameters."""

    num_particles: int = 1024
    motion: MotionConfig = field(default_factory=MotionConfig)
    likelihood: str = "zcos"  # "zcos" (z-scored cosine) | "cos"
    likelihood_temp: float = 20.0  # "cos": logits = temp * cosine
    likelihood_zscale: float = 9.0  # "zcos": log-weight spread in std units
    ess_threshold: float = 0.5  # resample when ESS < threshold * N
    init_sigma_pos: float = 2.0
    init_sigma_vel: float = 1.0
    seed: int = 0
    lost_conf_threshold: float = 0.0  # conf below => lost (0 disables)
    lost_conf_ratio: float = 0.0  # conf below ratio * locked EMA => lost

    def resolve(self) -> "FilterConfig":
        if self.num_particles <= 0:
            raise ValueError("filter.num_particles must be positive")
        if self.likelihood not in ("zcos", "cos"):
            raise ValueError("filter.likelihood must be 'zcos' or 'cos'")
        if not 0.0 <= self.ess_threshold <= 1.0:
            raise ValueError("filter.ess_threshold must be in [0, 1]")
        return self


@dataclass
class TrackerConfig:
    """Tracker orchestration. Mode "dense" pools every particle from one
    search-window forward; mode "crop" embeds one crop_size crop per particle
    in one batched forward. crop_impl (crop mode): "frame" samples the crops
    from the frame through a crop_region x crop_region region per particle;
    "window" and "window-pallas" sample them from one window_size resampled
    search window, "window-pallas" through kernel K2 on CUDA tensors."""

    mode: str = "dense"  # "dense" | "crop"
    search_scale: float = 4.0
    crop_size: int = 32
    crop_region: int = 64
    crop_impl: str = "frame"
    window_size: int = 256
    roi_grid: int = 5
    appearance: str = "cells"  # "pooled" | "cells"
    center_features: bool = True
    template_ema: float = 0.02
    template_update_conf: float = 0.5
    template_anchor_mix: float = 0.5
    redetect_window_boost: float = 1.5
    redetect_noise_boost: float = 2.0
    redetect_global_after: int = 0  # lost frames before a whole-frame scan; 0 = off
    redetect_global_grid: int = 7
    redetect_accept_conf: float = 0.0
    redetect_accept_z: float = 0.0
    redetect_accept_ratio: float = 0.0
    relock_conf_ratio: float = 0.0
    estimate: str = "mean"  # "mean" | "mode"
    coast_accel_ema: float = 0.6
    coast_accel_clip: float = 2.0

    def resolve(self) -> "TrackerConfig":
        if self.mode not in ("dense", "crop"):
            raise ValueError("tracker.mode must be 'dense' or 'crop'")
        if self.crop_impl not in ("frame", "window", "window-pallas"):
            raise ValueError(
                "tracker.crop_impl must be 'frame', 'window', or 'window-pallas'"
            )
        if self.estimate not in ("mean", "mode"):
            raise ValueError("tracker.estimate must be 'mean' or 'mode'")
        if not 0.0 <= self.coast_accel_ema <= 1.0:
            raise ValueError("tracker.coast_accel_ema must be in [0, 1]")
        if self.relock_conf_ratio < 0.0:
            raise ValueError("tracker.relock_conf_ratio must be >= 0")
        if self.appearance not in ("pooled", "cells"):
            raise ValueError("tracker.appearance must be 'pooled' or 'cells'")
        return self


@dataclass
class IOConfig:
    """Input source and output sink."""

    source: str = "synthetic:moving-square"  # image glob or synthetic:<name>
    num_frames: int = 0  # 0 = whole stream
    init_bbox: list[float] = field(default_factory=lambda: [96.0, 96.0, 32.0, 32.0])
    output: str = ""  # JSONL path; "" = stdout
    overlay: str = ""
    frame_size: list[int] = field(default_factory=lambda: [224, 224])  # H, W
    save_state: str = ""
    resume_state: str = ""


@dataclass
class RuntimeConfig:
    """Runtime substrate. The port reads `banks` only (to refuse > 1); the
    other keys exist so the JAX package's config files load unchanged."""

    banks: int = 1
    streams: int = 4
    mesh_banks: int = 1
    mesh_particles: int = 1
    mesh_model: int = 1
    donate_state: bool = True
    prefetch_frames: int = 2
    stream_roi: int = 0
    stream_roi_stride: int = 1
    stream_roi_out: int = 0
    stream_glob_stride: int = 8
    stream_glob_every: int = 4
    stream_readback: int = 4
    stream_steer_lag: int = 16
    stream_chunk: int = 1
    stream_steer_workers: int = 2
    stream_chunk_max: int = 0
    stream_fps_target: float = 60.0
    stream_lost_throttle: bool = True
    stream_chunk_unroll: bool = False
    profile_dir: str = ""  # a trace of bench, stream and serve, the program's spans in it ("" disables)


@dataclass
class TrainConfig:
    """Feature training settings (training/train.py's train_features, the
    train command): steps, the scene batch, AdamW, the objective's terms,
    freezing, the tracking probe and the checkpoint written."""

    steps: int = 2000
    batch_size: int = 32
    canvas: int = 160
    window: int = 0
    lr: float = 3e-4
    weight_decay: float = 0.05
    warmup: int = 100
    tau: float = 0.07
    num_random_negatives: int = 8
    template_jitter: float = 0.05
    cloud_weight: float = 1.0
    cloud_particles: int = 64
    cloud_sigma: float = 8.0
    cloud_zscale: float = 9.0
    distractor_margin: float = 0.45
    distractor_weight: float = 2.0
    distractor_centered_weight: float = 1.0
    distractor_absent_weight: float = 1.0
    lookalike_frac: float = 0.35
    blur_prob: float = 0.0
    blur_sigma: float = 1.2
    freeze_prefix: int = 0
    seed: int = 0
    checkpoint_out: str = "checkpoints/vit_trained.npz"
    checkpoint_dtype: str = "float32"
    metrics_out: str = ""
    log_every: int = 50
    dtype: str = "float32"
    eval_every: int = 0
    eval_frames: int = 32
    eval_particles: int = 512
    eval_clips: list[str] = field(
        default_factory=lambda: ["moving-square", "photometric", "rotation", "lookalikes"]
    )

    def resolve(self) -> "TrainConfig":
        if self.steps <= 0 or self.batch_size <= 0:
            raise ValueError("train.steps and train.batch_size must be positive")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError("train.dtype must be 'float32' or 'bfloat16'")
        if self.checkpoint_dtype not in ("float32", "bfloat16"):
            raise ValueError("train.checkpoint_dtype must be 'float32' or 'bfloat16'")
        return self


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    io: IOConfig = field(default_factory=IOConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def resolve(self) -> "Config":
        self.model.resolve()
        self.filter.resolve()
        self.tracker.resolve()
        self.train.resolve()
        if self.model.head_depth > 0 and self.tracker.mode != "dense":
            raise ValueError(
                "model.head_depth > 0 (residual discriminative head) "
                "requires tracker.mode == 'dense'"
            )
        r = self.runtime
        if r.stream_chunk_max and r.stream_chunk_max < r.stream_chunk:
            raise ValueError(
                "runtime.stream_chunk_max must be 0 (disabled) or >= "
                "runtime.stream_chunk"
            )
        return self

    def to_dict(self) -> dict[str, Any]:
        """The config as plain data. The port's own model keys are left out
        where they hold their defaults (PORT_MODEL_DEFAULTS), so that a
        config of the plain ViT reads the same in the JAX package's loader."""
        d = dataclasses.asdict(self)
        for k, v in PORT_MODEL_DEFAULTS.items():
            if d["model"][k] == v:
                del d["model"][k]
        return d

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        return _dataclass_from_dict(cls, d or {}).resolve()


def _dataclass_from_dict(cls: type, d: dict[str, Any]) -> Any:
    """Build nested dataclasses from a plain dict with unknown-key checks."""
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(names)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, v in d.items():
        ftype = names[name].type
        if isinstance(ftype, str) and ftype.endswith("Config"):
            kwargs[name] = _dataclass_from_dict(globals()[ftype], v or {})
        else:
            kwargs[name] = v
    return cls(**kwargs)


def load_config(path: str, overrides: list[str] | None = None) -> Config:
    """Load a config.yaml (or the same sections as a .json file, read
    without a YAML parser) with dotted CLI overrides."""
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml

            raw = yaml.safe_load(f) or {}
    cfg = Config.from_dict(raw)
    for ov in overrides or []:
        apply_override(cfg, ov)
    return cfg.resolve()


def apply_override(cfg: Config, spec: str) -> None:
    """Apply ``a.b.c=value`` to the config in place (YAML-parsed value)."""
    import yaml

    if "=" not in spec:
        raise ValueError(f"override must look like key.path=value, got {spec!r}")
    path, raw_val = spec.split("=", 1)
    value = yaml.safe_load(raw_val)
    parts = path.strip().split(".")
    obj: Any = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise ValueError(f"unknown config path {path!r} (at {p!r})")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise ValueError(f"unknown config path {path!r} (at {leaf!r})")
    setattr(obj, leaf, value)
