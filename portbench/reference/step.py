"""Plain reference of one dense tracking step: the cell scorer and
likelihood, the particle filter's propagate, update, estimate and resample,
the lost gate with its probe, the template EMA and the coasting output,
over the grid tokens of the configuration's model family (its ``tokens``,
``families/<family>.py``, which ``RefConfig`` carries).

Written from the published description of the method (a bootstrap particle
filter with systematic resampling; the family's own paper for its forward)
and the tracker's configuration keys, in float32 with TF32 off, by gathers
and loops where the program uses fused matrix forms: windows and ROI cells
are bilinear samples with clamp-to-edge, one window a filter, one forward a
window. Imports neither JAX nor the program. ``quant`` (the benchmark's
control) rounds every operand of the forward's products to a lower
precision.

State and record are plain dicts of one filter's tensors; the state's keys
are the program's state leaves by name (``particles``, ``log_weights``,
``template``, ``anchor``, ``box_wh``, ``center``, ``prev_scale``,
``frame_idx``, ``conf``, ``lost``, ``lost_count``, ``conf_ema``,
``coast_xy``, ``coast_vel``, ``coast_acc``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

from portbench.reference.layers import Quant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class RefConfig:
    """The values of a configuration file's ``tracker_config`` that a dense
    step reads, its ``dims`` and its family's forward `tokens` (params,
    images, rc, quant) -> grid tokens [B, g*g, D]; refuses what this
    reference does not implement."""

    def __init__(self, tc: dict, dims: dict, tokens: Callable):
        m, f, t = tc["model"], tc["filter"], tc["tracker"]
        self.dims, self.tokens = dims, tokens
        self.patch, self.image = dims["patch_size"], m["image_size"]
        self.ln_eps = m["ln_eps"]
        self.n = f["num_particles"]
        mo = f["motion"]
        self.sigma_pos, self.sigma_vel, self.sigma_scale, self.vel_decay = (
            mo["sigma_pos"], mo["sigma_vel"], mo["sigma_scale"], mo["vel_decay"])
        self.likelihood, self.temp, self.zscale = f["likelihood"], f["likelihood_temp"], f["likelihood_zscale"]
        self.ess_threshold = f["ess_threshold"]
        self.init_sigma_pos, self.init_sigma_vel = f["init_sigma_pos"], f["init_sigma_vel"]
        self.lost_thresh, self.lost_ratio = f["lost_conf_threshold"], f["lost_conf_ratio"]
        self.search_scale, self.roi_grid = t["search_scale"], t["roi_grid"]
        self.appearance, self.center_features = t["appearance"], t["center_features"]
        self.ema, self.upd_conf, self.anchor_mix = t["template_ema"], t["template_update_conf"], t["template_anchor_mix"]
        self.window_boost, self.noise_boost = t["redetect_window_boost"], t["redetect_noise_boost"]
        self.coast_ema, self.coast_clip = t["coast_accel_ema"], t["coast_accel_clip"]
        unsupported = {
            "tracker.mode": t["mode"] != "dense",
            "tracker.redetect_global_after": t["redetect_global_after"] != 0,
            "tracker.relock_conf_ratio": t["relock_conf_ratio"] != 0,
            "tracker.estimate": t["estimate"] != "mean",
            "model.head_depth": m.get("head_depth", 0) != 0,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"the reference step does not implement {bad}")
        self.probe = self.lost_thresh > 0.0 or self.lost_ratio > 0.0

    @property
    def grid(self) -> int:
        return self.image // self.patch


@contextlib.contextmanager
def full_f32():
    """float32 products without TF32, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- sampling ------------------------------------------------------------------


def _taps(t: torch.Tensor, size: int):
    """Clamp-to-edge bilinear taps of coordinates t: (i0, i1, weight of i1)."""
    t = torch.clamp(t, 0.0, size - 1.0)
    i0 = torch.floor(t)
    w = t - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=size - 1), w


def bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img [H, W, C] at pixel-centred (ys [..., 1], xs [..., 1] broadcast
    against each other) -> [..., C]."""
    h, w = img.shape[:2]
    y0, y1, wy = _taps(ys, h)
    x0, x1, wx = _taps(xs, w)
    wy, wx = wy[..., None], wx[..., None]
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def _offsets(n: int, device) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n - 0.5


def search_window(frame: torch.Tensor, center: torch.Tensor, side: torch.Tensor, out: int) -> torch.Tensor:
    """A square window of `side` frame px about `center` (x, y), resampled
    to [out, out, 3] and normalized with the ImageNet statistics."""
    t = _offsets(out, frame.device)
    ys = (center[1] + side * t)[:, None]
    xs = (center[0] + side * t)[None, :]
    win = bilinear(frame.float(), ys, xs)
    mean = torch.tensor(IMAGENET_MEAN, device=frame.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=frame.device) * 255.0
    return (win - mean) / std


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class Window:
    """One search window's token grid [g, g, D] (the family's forward) and
    its mean embedding."""

    def __init__(self, params, frame, center, side, rc: RefConfig, quant: Quant):
        self.center, self.side, self.rc = center, side, rc
        img = search_window(frame, center, side, rc.image)
        feat = rc.tokens(params, img[None], rc, quant)[0]
        self.feat = feat.reshape(rc.grid, rc.grid, -1)
        self.mean = feat.mean(dim=0)

    def boxes(self, xy: torch.Tensor, wh: torch.Tensor):
        """Boxes (centres xy [M, 2], sizes wh [M, 2], frame px) -> (cell
        features [M, C, D] (C = 1 for "pooled"), in-window flags [M])."""
        rc = self.rc
        s, p, k = rc.image, rc.patch, rc.roi_grid
        win_px = ((xy - self.center) / self.side + 0.5) * s - 0.5
        gxy = (win_px - (p - 1) / 2.0) / p
        gwh = wh / self.side * s / p
        in_win = torch.all((win_px >= 0) & (win_px <= s - 1), dim=-1)
        t = _offsets(k, xy.device)
        ys = gxy[:, 1:2] + gwh[:, 1:2] * t  # [M, K]
        xs = gxy[:, 0:1] + gwh[:, 0:1] * t
        feat = self.feat - self.mean if rc.center_features else self.feat
        cells = bilinear(feat, ys[:, :, None], xs[:, None, :])  # [M, K, K, D]
        cells = cells.reshape(xy.shape[0], k * k, -1)
        if rc.appearance == "pooled":
            cells = cells.mean(dim=1, keepdim=True)
        return cells, in_win


def cosines(cells: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
    """Mean over cells of the cosine between each cell and its template row."""
    return (l2n(cells) * tmpl).sum(dim=-1).mean(dim=-1)


def _side(box_wh: torch.Tensor, scale, search_scale: float) -> torch.Tensor:
    return search_scale * torch.sqrt(box_wh[0] * box_wh[1]) * scale


def init_template(params, frame, bbox, rc: RefConfig, quant: Quant = None) -> torch.Tensor:
    """The template [C, D] a filter starts from: the box's cells in a window
    about the box, each L2-normalized."""
    bbox = bbox.float()
    center, wh = bbox[:2] + bbox[2:] / 2.0, bbox[2:]
    win = Window(params, frame, center, _side(wh, 1.0, rc.search_scale), rc, quant)
    cells, _ = win.boxes(center[None], wh[None])
    return l2n(cells[0])


def _choose(ref_flag: torch.Tensor, margin: torch.Tensor, program_flag, tol: float) -> torch.Tensor:
    """A discrete decision: the reference's, unless the reference's own
    margin to the threshold is within `tol` (a tie to rounding) and the
    program took the other side; then the program's."""
    if program_flag is None:
        return ref_flag
    program_flag = torch.as_tensor(program_flag, dtype=torch.bool, device=ref_flag.device)
    return torch.where(torch.abs(margin) < tol, program_flag, ref_flag)


def step(params, rc: RefConfig, st: dict, frame: torch.Tensor, noise: dict, quant: Quant = None,
         program_lost=None, program_update=None, tie_tol: float = 0.0) -> tuple[dict, dict]:
    """One tracking step of one filter from state `st` on `frame` ([H, W, 3],
    0..255) with the step's draws -> (new state, record). program_lost /
    program_update: the program's lost flag and template-update decision
    for this step, taken only where the reference's own decision is within
    `tie_tol` of its threshold."""
    n = rc.n
    lost_prev = st["lost"].bool()
    particles = st["particles"].float()
    boost = rc.noise_boost if bool(lost_prev) else 1.0
    pos = particles[:, 0:2] + particles[:, 2:4] + rc.sigma_pos * noise["pos"] * boost
    vel = rc.vel_decay * particles[:, 2:4] + rc.sigma_vel * noise["vel"]
    log_s = particles[:, 4] + rc.sigma_scale * noise["scale"]
    particles = torch.cat([pos, vel, log_s[:, None]], dim=1)

    box_wh, prev_scale = st["box_wh"].float(), st["prev_scale"].float()
    side = _side(box_wh, prev_scale, rc.search_scale) * (rc.window_boost if bool(lost_prev) else 1.0)
    win = Window(params, frame, st["center"].float(), side, rc, quant)
    if rc.ema > 0.0 and rc.anchor_mix > 0.0:
        tmpl = l2n(rc.anchor_mix * st["anchor"].float() + (1.0 - rc.anchor_mix) * st["template"].float())
    else:
        tmpl = st["template"].float()
    boxes_wh = box_wh[None, :] * torch.exp(particles[:, 4:5])
    cells, in_win = win.boxes(particles[:, 0:2], boxes_wh)
    cos = cosines(cells, tmpl)
    del cells
    m = in_win.float()
    count = torch.clamp(m.sum(), min=1.0)
    mu = (cos * m).sum() / count
    sd = torch.sqrt(((cos - mu) ** 2 * m).sum() / count)
    if rc.likelihood == "zcos":
        loglik = rc.zscale * (cos - mu) / (sd + 1e-6)
    else:
        loglik = rc.temp * cos
    loglik = torch.where(in_win, loglik, loglik - 1e4)

    log_w = st["log_weights"].float() + loglik
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    w = torch.exp(log_w)
    est = (w[:, None] * particles).sum(dim=0)
    ess = 1.0 / (w * w).sum()
    resample = bool(ess < rc.ess_threshold * n)
    if resample:
        positions = (noise["u"] + torch.arange(n, dtype=torch.float32, device=w.device)) / n
        cum = torch.cumsum(w / w.sum(), dim=0)
        cum[-1] = torch.clamp(cum[-1], min=1.0)
        idx = torch.clamp(torch.searchsorted(cum, positions, side="left"), 0, n - 1)
        new_particles, new_log_w = particles[idx], torch.full((n,), -math.log(n), device=w.device)
    else:
        new_particles, new_log_w = particles, log_w

    est_xy, est_scale = est[0:2], torch.exp(est[4])
    est_box = box_wh * est_scale
    conf = torch.amax(torch.where(in_win, cos, torch.full_like(cos, -1.0)))
    conf_gate = conf
    if rc.probe and bool(lost_prev):
        pwin = Window(params, frame, est_xy, _side(box_wh, prev_scale, rc.search_scale), rc, quant)
        pcells, pin = pwin.boxes(est_xy[None], est_box[None])
        conf_gate = torch.where(pin[0], cosines(pcells, tmpl)[0], torch.tensor(-1.0, device=cos.device))

    conf_ema = st["conf_ema"].float()
    unseeded = conf_ema < 0.0
    base = torch.where(unseeded, conf_gate, conf_ema)
    lost = conf_gate < rc.lost_thresh
    margin = conf_gate - rc.lost_thresh
    if rc.lost_ratio > 0.0:
        lost = lost | (conf_gate < rc.lost_ratio * base)
        ratio_margin = conf_gate - rc.lost_ratio * base
        margin = torch.where(torch.abs(ratio_margin) < torch.abs(margin), ratio_margin, margin)
    lost = _choose(lost, margin, program_lost, tie_tol)
    conf_ema_new = torch.where(lost, torch.where(unseeded, conf_ema, base), 0.9 * base + 0.1 * conf_gate)

    template = st["template"].float()
    if rc.ema > 0.0:
        ecells, _ = win.boxes(est_xy[None], est_box[None])
        cand = l2n((1.0 - rc.ema) * template + rc.ema * l2n(ecells[0]))
        update = (conf > rc.upd_conf) & ~lost & ~lost_prev
        update = _choose(update, conf - rc.upd_conf, None if program_update is None or bool(lost) or bool(lost_prev)
                         else program_update, tie_tol)
        template = torch.where(update, cand, template)

    est_vel = est[2:4]
    frame_max = torch.tensor([frame.shape[1] - 1.0, frame.shape[0] - 1.0], device=est.device)
    coast_xy, coast_vel, coast_acc = st["coast_xy"].float(), st["coast_vel"].float(), st["coast_acc"].float()
    acc_upd = torch.clamp((1.0 - rc.coast_ema) * coast_acc + rc.coast_ema * (est_vel - coast_vel),
                          -rc.coast_clip, rc.coast_clip)
    vel_lost = coast_vel + coast_acc
    if bool(lost):
        coast_xy_new = torch.minimum(torch.clamp(coast_xy + vel_lost, min=0.0), frame_max)
        coast_vel_new, coast_acc_new = vel_lost, coast_acc
    else:
        coast_xy_new, coast_vel_new, coast_acc_new = est_xy, est_vel, acc_upd
    new = {
        "particles": new_particles, "log_weights": new_log_w, "template": template,
        "anchor": st["anchor"].float(), "box_wh": box_wh,
        "center": st["center"].float() if bool(lost) else est_xy,
        "prev_scale": prev_scale if bool(lost) else est_scale,
        "frame_idx": st["frame_idx"] + 1, "conf": conf_gate, "lost": lost,
        "lost_count": st["lost_count"] + 1 if bool(lost) else torch.zeros_like(st["lost_count"]),
        "conf_ema": conf_ema_new, "coast_xy": coast_xy_new, "coast_vel": coast_vel_new, "coast_acc": coast_acc_new,
    }
    record = {
        "position": coast_xy_new, "box": box_wh * (prev_scale if bool(lost) else est_scale),
        "velocity": coast_vel_new, "conf": conf_gate, "ess": ess, "resampled": resample, "lost": bool(lost),
    }
    return new, record


def weighted_mean(particles: torch.Tensor, log_weights: torch.Tensor) -> torch.Tensor:
    """The cloud's weighted mean position [2]."""
    w = torch.softmax(log_weights.float(), dim=0)
    return (w[:, None] * particles[:, 0:2].float()).sum(dim=0)
