"""The port's DINOv2 ViT-g/14 features on the card against the benchmark's
plain float32 forward, on the search windows of g14reg-offline-1080p.

    python3 tools/port_dinov2_features.py --seeds 1 2 3 [--windows 8] [--out FILE]

For each seed: the configuration's tree drawn on the card from the seed
(portbench/families/dinov2.py ``weights``), the program's inference tree
from it (``resolve_vit_params``: LayerScale folded, bf16), a clip of the
cell's scene and windows of the tracker's search size about the target;
then the program's grid features (models/vit.py, the dense embedder's
``grid_tokens``) against the family's ``tokens`` in float32 with TF32 off,
and the control's (the same forward, its products' operands rounded to
float8 e4m3, portbench/check.py ``fp8_quant``) against the same. The
reading is the relative RMS distance of a window's features from the
float32 forward's, and the worst window is kept. The program must lie
below LIMIT and the control above it. One JSON line a seed, on standard
output and appended to --out. Needs the card; imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = "g14reg-offline-1080p"
# Relative RMS distance of the program's bf16 features from the float32
# forward's, at most; the float8 control must read more (PERF.md, section 6).
LIMIT = 0.05


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("port_dinov2_features: needs the card", file=sys.stderr)
        return 2
    from portbench import check, harness, scenes
    from portbench.reference import step as ref
    from vitparticlefiltertracker_tpu_torch.config import Config
    from vitparticlefiltertracker_tpu_torch.models.embedder import DenseEmbedSpec, grid_tokens
    from vitparticlefiltertracker_tpu_torch.models.params import resolve_vit_params
    from vitparticlefiltertracker_tpu_torch.models.vit import vit_forward_tokens

    wl, cfgf = harness.cell_files(CELL)
    fam = harness.load_family(cfgf["family"])
    tc, dims = cfgf["tracker_config"], cfgf["dims"]
    cfg = Config.from_dict(json.loads(json.dumps(tc)))
    spec = DenseEmbedSpec.from_config(cfg).vit
    rc = ref.RefConfig(tc, dims, fam.tokens)
    dev = torch.device("cuda")
    ok = True
    for seed in args.seeds:
        tree = fam.weights(harness.sub_seed(seed, 0x3E16), dims, dev)
        prm = resolve_vit_params(cfg, tree, dev)
        h, w = wl["frame_size"]
        frames, truth, size = scenes.make_clip(wl["scene"], args.windows, h, w, harness.sub_seed(seed, 0xC11B), dev)
        side = torch.tensor(float(tc["tracker"]["search_scale"] * max(size)), device=dev)
        prog, ctl = [], []
        for i in range(args.windows):
            center = torch.tensor(truth[i], device=dev)
            img = ref.search_window(frames[i], center, side, rc.image)[None]
            with torch.no_grad():
                got = grid_tokens(vit_forward_tokens(prm, img, spec), spec).float()
                with ref.full_f32():
                    want = fam.tokens(tree, img, rc)
                    low = fam.tokens(tree, img, rc, check.fp8_quant)
            prog.append(float((got - want).norm() / want.norm()))
            ctl.append(float((low - want).norm() / want.norm()))
        row = {"seed": seed, "program_rel_rms_max": max(prog), "control_rel_rms_min": min(ctl), "limit": LIMIT,
               "program_rel_rms": prog, "control_rel_rms": ctl, "card": torch.cuda.get_device_name(0)}
        row["ok"] = row["program_rel_rms_max"] < LIMIT < row["control_rel_rms_min"]
        ok &= row["ok"]
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                print(json.dumps(row), file=f)
        del tree, prm, frames
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
