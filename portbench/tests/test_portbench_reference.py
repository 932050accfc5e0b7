"""The reference step against the program at a tiny size on the CPU (both
in float32): from the program's state each step, the reference's record
and template equal the program's to rounding; the initial template too;
the noise it works out again is the program's draw."""

import json

import numpy as np
import pytest
import torch

from portbench import harness, scenes
from portbench.reference import noise as ref_noise
from portbench.reference import step as ref
from tiny import BENCH, DIMS
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.filters.particle import draw_step_noise, init_state, PFParams
from vitparticlefiltertracker_tpu_torch.runtime.banked import MultiStreamTracker
from vitparticlefiltertracker_tpu_torch.runtime.step_graph import state_leaves
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker

NAMES = ("particles", "log_weights", "template", "anchor", "box_wh", "center", "prev_scale", "key", "frame_idx",
         "conf", "lost", "lost_count", "conf_ema", "coast_xy", "coast_vel", "coast_acc", "blend")


def _config():
    cfg = json.loads((BENCH / "configs" / "vitb16-dense-1k.json").read_text())
    tc = cfg["tracker_config"]
    tc["model"].update(variant="custom", dtype="float32", **DIMS)
    tc["filter"].update(num_particles=256, seed=77)
    return tc


def _clip(k):
    out = [scenes.make_clip("occlusion", 24, 120, 160, 100 + i, "cpu") for i in range(k)]
    frames = np.stack([f.numpy() for f, _, _ in out], axis=1)  # [T, K, H, W, 3]
    boxes = np.stack([[t[0, 0] - s[0] / 2, t[0, 1] - s[1] / 2, s[0], s[1]] for _, t, s in out]).astype(np.float32)
    return frames, boxes


def test_noise_is_the_programs_draw():
    ours = ref_noise.step_noise(2**33 + 5, 17, 64, "cpu")
    theirs = draw_step_noise(2**33 + 5, 17, 64, torch.device("cpu"))
    for a, b in zip((ours["pos"], ours["vel"], ours["scale"], ours["u"]), theirs):
        assert torch.equal(a, b)
    center = torch.tensor([50.0, 60.0])
    cloud = ref_noise.init_cloud(9, center, 64, 2.0, 1.0)
    assert torch.equal(cloud, init_state(9, center, 64, PFParams()).particles)


@pytest.mark.parametrize("feeds", [1, 2])
def test_reference_step_follows_the_program(feeds):
    tc = _config()
    vit = harness.load_family("vit")
    w = vit.weights(5, DIMS, "cpu")
    frames, boxes = _clip(feeds)
    cfg = Config.from_dict(tc)
    if feeds == 1:
        tr = Tracker(cfg, vit_params=w, device="cpu")
        tr.init(frames[0, 0], boxes[0])
    else:
        tr = MultiStreamTracker(cfg, feeds, vit_params=w, device="cpu")
        tr.init(frames[0], boxes)
    rc = ref.RefConfig(tc, DIMS, vit.tokens)
    w_ref = vit.weights(5, DIMS, "cpu")
    gaps = {"pos": 0.0, "conf": 0.0, "template": 0.0, "anchor": 0.0}
    lost_seen = False
    with ref.full_f32():
        for b in range(feeds):
            t0 = ref.init_template(w_ref, torch.from_numpy(frames[0, b]), torch.from_numpy(boxes[b]), rc)
            anchor = tr.state.anchor if feeds == 1 else tr.state.anchor[b]
            gaps["anchor"] = max(gaps["anchor"], float((anchor - t0).abs().max()))
        for i in range(1, frames.shape[0]):
            st = {k: v.clone() for k, v in zip(NAMES, state_leaves(tr.state))}
            frame = frames[i, 0] if feeds == 1 else frames[i]
            row = tr.step_packed(torch.from_numpy(frame)).numpy()
            nxt = dict(zip(NAMES, state_leaves(tr.state)))
            for b in range(feeds):
                s = {k: (v if feeds == 1 else v[b]) for k, v in st.items()}
                seed = (int(s["key"][0]) << 32) | int(s["key"][1])
                nz = ref_noise.step_noise(seed, int(s["frame_idx"]), rc.n, "cpu")
                new, rec = ref.step(w_ref, rc, s, torch.from_numpy(frames[i, b]), nz)
                pos = row[[2 * b, 2 * b + 1]] if feeds > 1 else row[0:2]
                conf = row[6 * feeds + b]
                lost_seen |= bool(row[9 * feeds + b])
                assert bool(row[9 * feeds + b]) == rec["lost"]
                gaps["pos"] = max(gaps["pos"], float(np.abs(pos - rec["position"].numpy()).max()))
                gaps["conf"] = max(gaps["conf"], abs(float(conf) - float(rec["conf"])))
                tmpl = nxt["template"] if feeds == 1 else nxt["template"][b]
                gaps["template"] = max(gaps["template"], float((tmpl - new["template"]).abs().max()))
    assert gaps["pos"] < 1e-3 and gaps["conf"] < 1e-5 and gaps["template"] < 1e-5 and gaps["anchor"] < 1e-5, gaps
    assert lost_seen  # the lost gate and the probe ran
