"""ViT weights: the repo's npz checkpoint reader and writer, random init, and
the inference cast — the port of the JAX package's ``models/params.py``.

The npz format is the JAX package's ``__vpt_format__`` v2: leaves keyed by
"/"-joined paths, fused ``wqkv`` columns head-major, and bfloat16 leaves
stored as uint16 with a ``__vpt_dtypes__`` JSON sidecar. The reader and
the writer use numpy only and move bfloat16 through uint16 by a bit view,
so a file round-trips bit for bit with the JAX package's reader and writer.

Random init draws JAX's threefry numbers (``models/jax_random.py``), so one
seed gives the JAX package's weights. A head-only file (``__vpt_trunk_seed__``)
holds a trained residual head; its trunk is that random init, regenerated in
memory on the run's device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from vitparticlefiltertracker_tpu_torch.models import jax_random
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


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def leaf_to_numpy(x: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """One leaf -> (stored array, sidecar dtype name or None): a bfloat16 or
    float16 leaf as its 16 bits in a uint16 array (never converted through
    floats), as the JAX package stores an ml_dtypes leaf."""
    x = x.detach().to("cpu").contiguous()
    for name, dt in _TORCH_DTYPES.items():
        if x.dtype == dt:
            return x.view(torch.int16).numpy().view(np.uint16), name
    return x.numpy(), None


def save_params(path: str, params: dict, trunk_seed: int | None = None) -> None:
    """Write a parameter tree as the repo's npz checkpoint (format v2), the
    file the JAX package's ``save_params`` writes: leaves keyed by
    "/"-joined paths, bfloat16 leaves as uint16 named in the
    ``__vpt_dtypes__`` sidecar, and ``__vpt_format__``.

    trunk_seed: a head-only file. Only the ``head`` subtree is written, with
    ``__vpt_trunk_seed__``; a reader regenerates the trunk as the seeded
    random init (load_or_init). The caller vouches that the trunk is that
    init (true for head training, whose trunk is frozen).
    """
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port writes .npz checkpoints only")
    if trunk_seed is not None:
        if "head" not in params:
            raise ValueError("a trunk_seed save needs a 'head' subtree")
        params = {"head": params["head"]}
    flat, dtypes = {}, {}
    for k, v in _flatten(params).items():
        flat[k], name = leaf_to_numpy(v)
        if name is not None:
            dtypes[k] = name
    if trunk_seed is not None:
        flat["__vpt_trunk_seed__"] = np.asarray(int(trunk_seed))
    flat["__vpt_format__"] = np.asarray(FORMAT_VERSION)
    flat["__vpt_dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_params(path: str, device: torch.device | str = "cpu") -> dict:
    """Read an npz checkpoint into the nested parameter dict of torch tensors.
    A head-only file's trunk seed comes back as the int ``__trunk_seed__``."""
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
    trunk_seed = raw.pop("__vpt_trunk_seed__", None)
    flat = {k: leaf_to_torch(v, dtypes.get(k)).to(device) for k, v in raw.items()}
    tree = _unflatten(flat)
    if trunk_seed is not None:
        tree["__trunk_seed__"] = int(trunk_seed)
    return tree


def _tn(k: jax_random.Key, shape, std: float, device) -> torch.Tensor:
    """std * truncated_normal(k, -2, 2, shape), std rounded to f32 first."""
    return jax_random.truncated_normal(k, -2.0, 2.0, shape, device) * float(np.float32(std))


def _ln(d: int, device) -> dict:
    return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}


def init_block_params(bkey: jax_random.Key, spec: VitSpec, device="cpu") -> dict:
    """One block of the JAX package's init_vit_params: split(bkey, 4) keys
    wqkv, wo, w1 and w2; LN ones and zeros, biases zeros; f32. A SwiGLU
    block draws w12 [d, 2 mlp] and w3 on the keys of w1 and w2. No
    LayerScale gammas: a tree without them runs each branch as it is."""
    d, mlp = spec.dim, spec.mlp_dim
    bk = jax_random.split(bkey, 4)
    if spec.ffn == "swiglu":
        ffn = {"w12": _tn(bk[2], (d, 2 * mlp), d**-0.5, device), "b12": torch.zeros(2 * mlp, device=device),
               "w3": _tn(bk[3], (mlp, d), mlp**-0.5, device), "b3": torch.zeros(d, device=device)}
    else:
        ffn = {"w1": _tn(bk[2], (d, mlp), d**-0.5, device), "b1": torch.zeros(mlp, device=device),
               "w2": _tn(bk[3], (mlp, d), mlp**-0.5, device), "b2": torch.zeros(d, device=device)}
    return {
        "ln1": _ln(d, device),
        "attn": {
            "wqkv": _tn(bk[0], (d, 3 * d), d**-0.5, device),
            "bqkv": torch.zeros(3 * d, device=device),
            "wo": _tn(bk[1], (d, d), d**-0.5, device),
            "bo": torch.zeros(d, device=device),
        },
        "ln2": _ln(d, device),
        "mlp": ffn,
    }


def _stack(blocks: list[dict]) -> dict:
    """Blocks stacked on a leading depth axis, leaf by leaf."""
    return {g: {n: torch.stack([b[g][n] for b in blocks]) for n in blocks[0][g]} for g in blocks[0]}


def init_vit_params(key: jax_random.Key, spec: VitSpec, device="cpu") -> dict:
    """The JAX package's init_vit_params, number for number: split(key,
    4 + depth) keys patch_embed, pos_embed, cls_token and the blocks; the
    head's blocks are keyed on split(fold_in(key, 0x4EAD), head_depth), so a
    head never changes the trunk. Registers (the port's alone) are drawn as
    the class token, on the spare key 3. Built leaf by leaf on `device`."""
    d = spec.dim
    patch_in = spec.patch_size * spec.patch_size * 3
    keys = jax_random.split(key, 4 + spec.depth)
    params = {
        "patch_embed": {"kernel": _tn(keys[0], (patch_in, d), patch_in**-0.5, device),
                        "bias": torch.zeros(d, device=device)},
        "pos_embed": _tn(keys[1], (spec.seq_len, d), 0.02, device),
        "ln_final": _ln(d, device),
    }
    if spec.use_cls_token:
        params["cls_token"] = _tn(keys[2], (d,), 0.02, device)
    if spec.registers:
        params["reg_tokens"] = _tn(keys[3], (spec.registers, d), 0.02, device)
    params["blocks"] = _stack([init_block_params(keys[4 + i], spec, device) for i in range(spec.depth)])
    if spec.head_depth > 0:
        hkeys = jax_random.split(jax_random.fold_in(key, 0x4EAD), spec.head_depth)
        params["head"] = {
            "blocks": _stack([init_block_params(k, spec, device) for k in hkeys]),
            "ln": _ln(d, device),
        }
    return params


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def trunk_key(seed: int) -> jax_random.Key:
    """The key of the random trunk for a seed (filter.seed, or a head-only
    file's trunk seed)."""
    return jax_random.key(int(seed) ^ 0x5EED)


def load_or_init(checkpoint: str, spec: VitSpec, seed: int = 0, device="cpu") -> dict:
    """Load a checkpoint, or the JAX package's random init for `seed`. A
    head-only file gets its trunk regenerated from its trunk seed."""
    if not checkpoint:
        return init_vit_params(trunk_key(seed), spec, device)
    prm = load_params(checkpoint, device)
    ts = prm.pop("__trunk_seed__", None)
    if ts is None:
        return prm
    if spec.head_depth <= 0:
        # The JAX package's refusal, word for word.
        raise ValueError(
            f"{checkpoint} is a head-only checkpoint but "
            "model.head_depth is 0 — the trained head would be silently "
            "ignored and the model would be pure random init. Set "
            "model.head_depth to the depth the head was trained with "
            "(configs/train-head*.yaml: 2)."
        )
    trunk = init_vit_params(trunk_key(ts), spec._replace(head_depth=0), device)
    return dict(trunk, head=prm["head"])


def fold_layer_scale(blocks: dict) -> dict:
    """Depth-stacked blocks with their LayerScale gammas folded into the
    branches' last products, in f32: gamma * (y @ w + b) = y @ (w * gamma) +
    b * gamma, gamma scaling w's output columns. Exact algebra, so only the
    rounding of the weights to the compute dtype differs from applying
    gamma after the branch; it holds under the row-parallel sum too, where
    each rank's rows of w carry the same column scale and the bias is added
    once. Blocks without gammas come back as they are."""
    if "ls1" not in blocks:
        return blocks
    g1, g2 = blocks["ls1"]["gamma"].float(), blocks["ls2"]["gamma"].float()
    w, b = ("w3", "b3") if "w3" in blocks["mlp"] else ("w2", "b2")
    attn, mlp = blocks["attn"], blocks["mlp"]
    out = {k: v for k, v in blocks.items() if k not in ("ls1", "ls2")}
    out["attn"] = dict(attn, wo=attn["wo"].float() * g1[:, None, :], bo=attn["bo"].float() * g1)
    out["mlp"] = dict(mlp, **{w: mlp[w].float() * g2[:, None, :], b: mlp[b].float() * g2})
    return out


def cast_for_inference(params: dict, spec: VitSpec) -> dict:
    """Fold LayerScale into the blocks (fold_layer_scale), widen the LN
    params to f32 (the one form the pre-norm junction kernel reads; exact,
    and the LN's f32 statistics promote them to f32 at use anyway), then
    pre-cast the block matmul weights (trunk and head) and the
    cls/register/pos embeddings to the compute dtype once; patch_embed keeps
    its stored dtype. Without LayerScale the values are bit-identical to
    casting at every use."""
    dt = spec.dtype
    if "ls1" in params["blocks"]:
        params = dict(params, blocks=fold_layer_scale(params["blocks"]))
    if "head" in params and "ls1" in params["head"]["blocks"]:
        params["head"] = dict(params["head"], blocks=fold_layer_scale(params["head"]["blocks"]))
    params = _widen_layer_norms(params)
    if dt == torch.float32:
        return params

    def cast_blocks(blocks: dict) -> dict:
        return dict(blocks, **{g: _map(blocks[g], lambda x: x.to(dt)) for g in ("attn", "mlp")})

    out = dict(params, blocks=cast_blocks(params["blocks"]))
    if "head" in params:
        out["head"] = dict(params["head"], blocks=cast_blocks(params["head"]["blocks"]))
    for k in ("cls_token", "reg_tokens", "pos_embed"):
        if out.get(k) is not None:
            out[k] = out[k].to(dt)
    return out


def _widen_layer_norms(params: dict) -> dict:
    """The tree with every LayerNorm's scale and bias (the blocks' ln1 and
    ln2, ln_final, the head's blocks and ln) in f32; the tree itself where
    they all are."""
    lns = [params["blocks"]["ln1"], params["blocks"]["ln2"], params["ln_final"]]
    if "head" in params:
        lns += [params["head"]["blocks"]["ln1"], params["head"]["blocks"]["ln2"], params["head"]["ln"]]
    if all(v.dtype == torch.float32 for ln in lns for v in ln.values()):
        return params

    def widen(ln: dict) -> dict:
        return {k: v.float() for k, v in ln.items()}

    def blocks(b: dict) -> dict:
        return dict(b, ln1=widen(b["ln1"]), ln2=widen(b["ln2"]))

    out = dict(params, blocks=blocks(params["blocks"]), ln_final=widen(params["ln_final"]))
    if "head" in params:
        out["head"] = dict(params["head"], blocks=blocks(params["head"]["blocks"]), ln=widen(params["head"]["ln"]))
    return out


def resolve_vit_params(cfg, vit_params=None, device="cpu") -> dict:
    """Load cfg.model.checkpoint (or random-init) unless weights are given,
    check the head against model.head_depth (a headless config drops a
    checkpoint's head), and pre-cast for inference. In crop mode a random
    init sizes pos_embed for one crop (g*g rows); a checkpoint keeps its
    own, of which the tracker reads the first g*g."""
    spec = VitSpec.from_config(cfg.model)
    if cfg.tracker.mode == "crop":
        spec = spec._replace(image_size=cfg.tracker.crop_size)
    if vit_params is None:
        vit_params = load_or_init(cfg.model.checkpoint, spec, cfg.filter.seed, device)
    else:
        vit_params = _map(vit_params, lambda x: x.to(device))
    if spec.head_depth > 0:
        if "head" not in vit_params:
            raise ValueError(
                f"model.head_depth={spec.head_depth} but the weights have no "
                "'head' subtree — train one with configs/train-head.yaml or set "
                "model.head_depth: 0"
            )
        have = int(vit_params["head"]["blocks"]["attn"]["wqkv"].shape[0])
        if have != spec.head_depth:
            raise ValueError(
                f"model.head_depth={spec.head_depth} but the checkpoint's head has {have} blocks"
            )
    elif "head" in vit_params:
        vit_params = {k: v for k, v in vit_params.items() if k != "head"}
    return cast_for_inference(vit_params, spec)
