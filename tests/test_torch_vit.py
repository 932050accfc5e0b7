"""Port parity: ViT forward, weights and the bridge
(vitparticlefiltertracker_tpu_torch/models/{vit,params}.py, bridge.py).

Bridged weights from the JAX package's init_vit_params go through both
packages' vit_forward_tokens on the same numpy images. The JAX side runs
under HIGHEST matmul precision (this JAX build's default is bf16-class even
on the CPU), so f32 agrees to float rounding; bf16 agrees to bf16 rounding.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitparticlefiltertracker_tpu.models import params as jparams
from vitparticlefiltertracker_tpu.models import vit as jvit
from vitparticlefiltertracker_tpu_torch import bridge
from vitparticlefiltertracker_tpu_torch.models import params as tparams
from vitparticlefiltertracker_tpu_torch.models import vit as tvit
from vitparticlefiltertracker_tpu_torch.ops.prenorm_junction import layer_norm_plain

CKPT = "checkpoints/vit_b16_tracking.npz"


def _specs(dtype_name, pos, image_size=64):
    kw = dict(depth=2, dim=128, heads=2, mlp_dim=256, patch_size=16, image_size=image_size,
              use_pos_embed=pos)
    jd = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    td = torch.float32 if dtype_name == "float32" else torch.bfloat16
    return (jvit.VitSpec(dtype=jd, use_flash_attention=False, **kw),
            tvit.VitSpec(dtype=td, **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# f32: float rounding through two blocks (measured max 2e-6). bf16: the two
# frameworks round at other places (GELU, bias adds); outputs reach |x| ~ 3.4,
# where one bf16 ulp is 2^-6, and the measured max is two ulps (0.031).
TOL = {"float32": 2e-5, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [False, True])
def test_vit_forward_tokens_matches_jax(dtype_name, pos):
    _check_forward_tokens(dtype_name, pos, 64)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("image_size", [32, 80])
def test_vit_forward_tokens_at_crop_token_counts_matches_jax(dtype_name, image_size):
    """T = 4 (a 32-px crop, as in crop mode) and T = 25 (above K1's small
    path): the blocks' attention reads q, k, v as views of the fused qkv
    activation and reshapes its output as a view, and still agrees with JAX."""
    _check_forward_tokens(dtype_name, True, image_size)


def _check_forward_tokens(dtype_name, pos, image_size):
    jspec, tspec = _specs(dtype_name, pos, image_size)
    jp = jparams.cast_for_inference(jvit.init_vit_params(jax.random.key(0), jspec), jspec)
    images = np.random.default_rng(1).standard_normal((2, image_size, image_size, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jvit.vit_forward_tokens(jp, jnp.asarray(images), jspec), np.float32)
    tp = bridge.params_from_numpy(_np_tree(jp), tspec)
    got = tvit.vit_forward_tokens(tp, torch.from_numpy(images), tspec).float().numpy()
    assert got.shape == want.shape == (2, (image_size // 16) ** 2, 128)
    tol = TOL[dtype_name]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_patchify_matches_jax():
    imgs = np.arange(2 * 32 * 48 * 3, dtype=np.float32).reshape(2, 32, 48, 3)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(imgs), 16).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(imgs), 16)),
    )


def test_pool_tokens_and_layer_norm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 4 + 1
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = np.asarray(jvit._layer_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jnp.float32, 1e-6))
    got = layer_norm_plain(torch.from_numpy(x), torch.from_numpy(p["scale"]), torch.from_numpy(p["bias"]),
                           torch.float32, 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    spec = tvit.VitSpec(dim=32)
    np.testing.assert_allclose(tvit.pool_tokens(torch.from_numpy(x), spec).numpy(),
                               x.mean(axis=1), rtol=1e-6, atol=1e-6)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_npz_reader_bit_exact_on_b16_checkpoint():
    want = dict(_leaves(jparams.load_params(CKPT)))
    got = dict(_leaves(tparams.load_params(CKPT)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    del want, got


def test_cast_for_inference_matches_jax():
    jspec, tspec = _specs("bfloat16", False)
    jp = jvit.init_vit_params(jax.random.key(3), jspec)
    want = dict(_leaves(jparams.cast_for_inference(jp, jspec)))
    got = dict(_leaves(tparams.cast_for_inference(bridge.params_from_numpy(_np_tree(jp), tspec), tspec)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def test_random_init_shapes_match_jax():
    """The port's random init is the JAX package's, number for number (the
    name predates threefry in the port, when only the shapes agreed)."""
    jspec, tspec = _specs("float32", True)
    want = dict(_leaves(jvit.init_vit_params(jax.random.key(0), jspec)))
    got = dict(_leaves(tparams.init_vit_params(tparams.jax_random.key(0), tspec)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # load_or_init without a checkpoint: JAX's weights for the same filter.seed.
    want = dict(_leaves(jparams.load_or_init("", jspec, seed=3)))
    got = dict(_leaves(tparams.load_or_init("", tspec, seed=3)))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_head_only_checkpoint_raises(tmp_path):
    """A head-only file is refused only in a headless config, with the JAX
    package's message; with model.head_depth > 0 it loads
    (tests/test_torch_jax_random.py holds that load to JAX's)."""
    path = str(tmp_path / "head.npz")
    np.savez(path, **{"head/ln/scale": np.ones(4, np.float32),
                      "__vpt_trunk_seed__": np.asarray(0),
                      "__vpt_format__": np.asarray(2),
                      "__vpt_dtypes__": np.frombuffer(json.dumps({}).encode(), np.uint8)})
    jspec, tspec = _specs("float32", False)
    with pytest.raises(ValueError, match="head-only") as want:
        jparams.load_or_init(path, jspec)
    with pytest.raises(ValueError, match="head-only") as got:
        tparams.load_or_init(path, tspec)
    assert str(got.value) == str(want.value)
    assert tparams.load_params(path)["__trunk_seed__"] == 0


def test_head_depth_not_ported():
    """The residual head is ported (the name predates that): head_depth
    reaches the spec, and the forward emits concat(trunk, head) features of
    2 * dim, 14 K1 calls at ViT-B/16's depth 12 plus a head of 2."""
    from vitparticlefiltertracker_tpu_torch.config import ModelConfig

    m = ModelConfig(variant="vit-t16", head_depth=2).resolve()
    spec = tvit.VitSpec.from_config(m)
    assert spec.head_depth == 2 and spec.out_dim == 2 * spec.dim
    tspec = _specs("float32", False)[1]._replace(head_depth=2)
    prm = tparams.init_vit_params(tparams.jax_random.key(1), tspec)
    images = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    out = tvit.vit_forward_tokens(prm, images, tspec)
    assert out.shape == (3, 16, 2 * 128)
    headless = tvit.vit_forward_tokens(prm, images, tspec._replace(head_depth=0))
    torch.testing.assert_close(out[..., :128], headless, rtol=0, atol=0)
