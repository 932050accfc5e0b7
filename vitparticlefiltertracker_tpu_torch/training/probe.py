"""The tracking probe of feature training — the port of the JAX package's
``training/probe.py``.

Ranking accuracy does not predict tracking RMSE, so the trainer selects its
checkpoint by running the real tracker on held-out synthetic clips with the
current weights. The probe builds one Tracker per set of config overrides
once, stages the clips on the device once, and per evaluation loads the
weights into each tracker in place (Tracker.load_weights, so the step
graphs the trackers captured read them), then runs init and
track_clip_device. On the card the trackers run in bfloat16 (K1 in every
attention), on the CPU in float32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# Per-clip tracker overrides (tools/eval_quality.py's CLIP_OVERRIDES): the
# lookalikes clip is only meaningful under the robustness stack (relative
# lost gate, global re-detection, re-lock hysteresis). Dotted config paths
# (config.apply_override).
PROBE_OVERRIDES: dict[str, dict[str, str]] = {
    "lookalikes": {
        "filter.lost_conf_ratio": "0.55",
        "tracker.redetect_global_after": "4",
        "tracker.relock_conf_ratio": "0.9",
        "tracker.redetect_accept_ratio": "0.85",
        "tracker.redetect_accept_z": "3.0",
    },
}


def _blur_clip(arr: np.ndarray, sigma: float) -> np.ndarray:
    """Separable 7-tap Gaussian over a uint8 clip [T, H, W, 3] on the host
    (probe staging only)."""
    t = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * np.square(t / sigma))
    k /= k.sum()
    x = arr.astype(np.float32)
    for axis in (1, 2):
        pad = [(0, 0)] * 4
        pad[axis] = (3, 3)
        xp = np.pad(x, pad, mode="edge")
        acc = np.zeros_like(x)
        for i in range(7):
            sl = [slice(None)] * 4
            sl[axis] = slice(i, i + x.shape[axis])
            acc += k[i] * xp[tuple(sl)]
        x = acc
    return np.clip(x, 0, 255).astype(np.uint8)


def make_probe(
    train_cfg,
    clips: tuple[str, ...] = ("moving-square", "photometric", "rotation", "lookalikes"),
    frames: int = 32,
    frame_size: tuple[int, int] = (480, 640),
    num_particles: int = 512,
    seed: int = 0,
    image_size: int = 224,
    device="cuda",
) -> Callable[[dict], dict]:
    """Build probe(params) -> {"probe_<clip>": RMSE px, ..., "probe_rmse": mean}.

    The geometry mirrors the flagship eval (the training config's model
    variant and head, dense mode, 480x640 clips) with fewer particles and
    frames. A clip named "<family>+blur" is that clip through _blur_clip.
    """
    from vitparticlefiltertracker_tpu_torch.config import Config, apply_override
    from vitparticlefiltertracker_tpu_torch.io.video import open_source
    from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker
    from vitparticlefiltertracker_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    base = {
        "model": {
            "variant": train_cfg.model.variant,
            "image_size": image_size,
            "dtype": "bfloat16" if dev.type == "cuda" else "float32",
            "use_flash_attention": False,
            "scan_unroll": train_cfg.model.scan_unroll,
            # A head run scores the blended split cosine the tracker serves.
            "head_depth": train_cfg.model.head_depth,
            "head_blend": train_cfg.model.head_blend,
        },
        "filter": {"num_particles": num_particles},
        "tracker": {"mode": "dense"},
    }

    # One Tracker per distinct override set (the gates change the step).
    trackers: dict[frozenset, object] = {}
    staged = []
    for clip in clips:
        fam = clip.removesuffix("+blur")
        ov = PROBE_OVERRIDES.get(fam, {})
        key = frozenset(ov.items())
        if key not in trackers:
            cfg = Config.from_dict(base)
            for path, val in ov.items():
                apply_override(cfg, f"{path}={val}")
            trackers[key] = Tracker(cfg.resolve(), device=dev)
        src = open_source(f"synthetic:{fam}", frames, frame_size, seed=seed)
        arr = np.stack(list(src))
        if clip.endswith("+blur"):
            # A codec proxy: a sigma-1 Gaussian for what an mp4 roundtrip
            # does to fine pattern detail.
            arr = _blur_clip(arr, 1.0)
        staged.append((clip, trackers[key], arr[0], torch.from_numpy(arr[1:]).to(dev), src.truth[1:],
                       np.asarray(src.init_bbox, np.float32)))

    def probe(params: dict) -> dict:
        for tracker in trackers.values():
            tracker.load_weights(params)
        out = {}
        for clip, tracker, frame0, clip_dev, truth, bbox in staged:
            tracker.init(frame0, bbox)
            pos = tracker.track_clip_device(clip_dev).position.cpu().numpy()
            err = np.linalg.norm(pos - truth, axis=1)
            out[f"probe_{clip}"] = float(np.sqrt(np.mean(err**2)))
        out["probe_rmse"] = float(np.mean(list(out.values())))
        return out

    return probe
