"""ViT weights: the repo's npz checkpoint reader, random init, and the
inference cast — the port of the JAX package's ``models/params.py``.

The npz format is the JAX package's ``__vpt_format__`` v2: leaves keyed by
"/"-joined paths, fused ``wqkv`` columns head-major, and bfloat16 leaves
stored as uint16 with a ``__vpt_dtypes__`` JSON sidecar. The reader uses
numpy only and turns bfloat16-as-uint16 into ``torch.bfloat16`` by a bit
view, so every leaf is bit-identical to what the JAX reader gives.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.models.vit import VitSpec

FORMAT_VERSION = 2
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def leaf_to_torch(arr: np.ndarray, dtype_name: str | None = None) -> torch.Tensor:
    """One stored leaf -> torch tensor; 2-byte uint leaves named in the
    sidecar are reinterpreted bit for bit (never converted through floats)."""
    if dtype_name is None:
        return torch.from_numpy(np.ascontiguousarray(arr))
    if dtype_name not in _TORCH_DTYPES or arr.dtype.itemsize != 2:
        raise ValueError(f"unsupported stored dtype {dtype_name!r} ({arr.dtype})")
    bits = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(bits).view(_TORCH_DTYPES[dtype_name])


def load_params(path: str, device: torch.device | str = "cpu") -> dict:
    """Read an npz checkpoint into the nested parameter dict of torch tensors."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port reads .npz checkpoints only")
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    dtypes = {}
    if "__vpt_dtypes__" in raw:
        dtypes = json.loads(raw.pop("__vpt_dtypes__").tobytes().decode())
    version = int(raw.pop("__vpt_format__", 0))
    if version != FORMAT_VERSION:
        raise ValueError(
            f"{path}: param format v{version}, this build expects v{FORMAT_VERSION}"
        )
    if "__vpt_trunk_seed__" in raw:
        raise ValueError(
            f"{path} is a head-only checkpoint: its trunk is regenerated with "
            "JAX's threefry random init, which the port cannot reproduce"
        )
    flat = {k: leaf_to_torch(v, dtypes.get(k)).to(device) for k, v in raw.items()}
    return _unflatten(flat)


def init_vit_params(spec: VitSpec, generator: torch.Generator, device="cpu") -> dict:
    """Truncated-normal / zeros init, f32 master weights.

    Same shapes and scales as the JAX package's init_vit_params, but drawn
    from a torch.Generator: the numbers differ from JAX's threefry draws.
    """
    d, mlp = spec.dim, spec.mlp_dim
    patch_in = spec.patch_size * spec.patch_size * 3
    depth = spec.depth

    def tn(shape, std):
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        return t

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32)

    params = {
        "patch_embed": {"kernel": tn((patch_in, d), patch_in**-0.5), "bias": zeros(d)},
        "pos_embed": tn((spec.seq_len, d), 0.02),
        "ln_final": {"scale": ones(d), "bias": zeros(d)},
        "blocks": {
            "ln1": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "attn": {
                "wqkv": tn((depth, d, 3 * d), d**-0.5),
                "bqkv": zeros(depth, 3 * d),
                "wo": tn((depth, d, d), d**-0.5),
                "bo": zeros(depth, d),
            },
            "ln2": {"scale": ones(depth, d), "bias": zeros(depth, d)},
            "mlp": {
                "w1": tn((depth, d, mlp), d**-0.5),
                "b1": zeros(depth, mlp),
                "w2": tn((depth, mlp, d), mlp**-0.5),
                "b2": zeros(depth, d),
            },
        },
    }
    if spec.use_cls_token:
        params["cls_token"] = tn((d,), 0.02)
    return _map(params, lambda x: x.to(device))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def load_or_init(checkpoint: str, spec: VitSpec, seed: int = 0, device="cpu") -> dict:
    if checkpoint:
        return load_params(checkpoint, device)
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed) ^ 0x5EED)
    return init_vit_params(spec, g, device)


def cast_for_inference(params: dict, spec: VitSpec) -> dict:
    """Pre-cast the block matmul weights (and cls/pos embeddings) to the
    compute dtype once; LN params and patch_embed keep their stored dtype.
    Values are bit-identical to casting at every use."""
    dt = spec.dtype
    if dt == torch.float32:
        return params
    out = dict(params)
    blocks = dict(params["blocks"])
    for g in ("attn", "mlp"):
        blocks[g] = _map(params["blocks"][g], lambda x: x.to(dt))
    out["blocks"] = blocks
    for k in ("cls_token", "pos_embed"):
        if out.get(k) is not None:
            out[k] = out[k].to(dt)
    return out


def resolve_vit_params(cfg, vit_params=None, device="cpu") -> dict:
    """Load cfg.model.checkpoint (or random-init) unless weights are given,
    drop a checkpoint's residual head, and pre-cast for inference. In crop
    mode a random init sizes pos_embed for one crop (g*g rows); a
    checkpoint keeps its own, of which the tracker reads the first g*g."""
    spec = VitSpec.from_config(cfg.model)
    if cfg.tracker.mode == "crop":
        spec = spec._replace(image_size=cfg.tracker.crop_size)
    if vit_params is None:
        vit_params = load_or_init(cfg.model.checkpoint, spec, cfg.filter.seed, device)
    else:
        vit_params = _map(vit_params, lambda x: x.to(device))
    if "head" in vit_params:
        vit_params = {k: v for k, v in vit_params.items() if k != "head"}
    return cast_for_inference(vit_params, spec)
