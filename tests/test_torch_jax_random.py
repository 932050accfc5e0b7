"""Port parity: JAX's threefry random numbers and random init in torch
(vitparticlefiltertracker_tpu_torch/models/jax_random.py, models/params.py).

Keys, bits and uniforms are held bit for bit to the installed JAX on the
CPU; erf_inv, truncated_normal and the initialised weights within one f32
ulp (each test prints how many values are not bit-exact).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitparticlefiltertracker_tpu.models import params as jparams
from vitparticlefiltertracker_tpu.models import vit as jvit
from vitparticlefiltertracker_tpu_torch.models import jax_random as jr
from vitparticlefiltertracker_tpu_torch.models import params as tparams
from vitparticlefiltertracker_tpu_torch.models import vit as tvit

SEEDS = [0, 1, 7, 12345, -1, 2**31 - 1, 0x5EED ^ 3]
FOLDS = [0, 1, 17, 0x4EAD, 0x5EED, 0x5EED1, 0xFFFFFFFF]


def _words(k) -> tuple[int, int]:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 ulps (ordered integer views)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _within_one_ulp(got: np.ndarray, want: np.ndarray, what: str) -> None:
    d = _ulps(got, want)
    print(f"{what}: {int((d > 0).sum())} of {d.size} values not bit-exact, max {int(d.max())} ulp")
    assert d.max() <= 1, what


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_and_bits_bit_exact(seed):
    k = jax.random.key(seed)
    assert jr.key(seed) == _words(k)
    for d in FOLDS:
        assert jr.fold_in(jr.key(seed), d) == _words(jax.random.fold_in(k, d)), d
    want = [tuple(int(x) for x in row) for row in np.asarray(jax.random.key_data(jax.random.split(k, 16)))]
    assert jr.split(jr.key(seed), 16) == want
    for shape in [(7,), (3, 5), (128, 33)]:
        bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(jr.random_bits(jr.key(seed), shape).numpy(), bits)


def test_split_does_not_depend_on_the_count():
    """split(k, n)[i] == fold_in(k, i) in JAX's partitionable threefry, so a
    depth-1 spec's init gives the depth-12 model's patch_embed and block 0
    (test_init_vit_params_b16_patch_embed_and_block0 rests on this)."""
    k = jax.random.key(0x5EED)
    assert np.array_equal(np.asarray(jax.random.key_data(jax.random.split(k, 5))),
                          np.asarray(jax.random.key_data(jax.random.split(k, 16)))[:5])


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.3, 2.5)])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_uniform_bit_exact(seed, bounds):
    lo, hi = bounds
    shape = (64, 129)
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, minval=lo, maxval=hi))
    got = jr.uniform(jr.key(seed), shape, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_erf_constants_are_jax_erf():
    sqrt2 = np.float32(np.sqrt(2.0))
    for x, v in jr.ERF_OF.items():
        assert float(np.asarray(jax.lax.erf(jnp.float32(x) / sqrt2))) == v, x


def test_erf_inv_over_every_truncated_normal_input():
    """Every input truncated_normal(-2, 2) can give erf_inv: the 2**23
    uniforms between erf(-sqrt 2) and erf(sqrt 2)."""
    a, b = jr.ERF_OF[-2.0], jr.ERF_OF[2.0]
    mant = np.arange(2**23, dtype=np.uint32)
    floats = torch.from_numpy((mant | np.uint32(0x3F800000)).view(np.float32)) - 1.0
    u = torch.clamp(jr._fma(floats, jr._f32(b - a), a), min=a)
    want_u = np.asarray(jax.jit(lambda f: jnp.maximum(a, f * jnp.float32(b - a) + a))(floats.numpy()))
    np.testing.assert_array_equal(u.numpy(), want_u)  # the inputs themselves are JAX's
    want = np.asarray(jax.jit(jax.lax.erf_inv)(want_u))
    _within_one_ulp(jr.erf_inv(u).numpy(), want, "erf_inv")


@pytest.mark.parametrize("seed", [0, 5, 0x5EED])
def test_truncated_normal_matches_jax(seed):
    shape = (300, 257)
    want = np.asarray(jax.random.truncated_normal(jax.random.key(seed), -2.0, 2.0, shape))
    got = jr.truncated_normal(jr.key(seed), -2.0, 2.0, shape).numpy()
    _within_one_ulp(got, want, f"truncated_normal seed {seed}")
    assert got.min() > -2.0 and got.max() < 2.0


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _compare_trees(got: dict, want: dict, what: str) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), what
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32, k
        _within_one_ulp(got[k].numpy(), w, f"{what} {k}")


def _tiny(head_depth):
    kw = dict(depth=2, dim=128, heads=2, mlp_dim=256, patch_size=16, image_size=64, head_depth=head_depth)
    return jvit.VitSpec(dtype=jnp.float32, use_flash_attention=False, **kw), tvit.VitSpec(dtype=torch.float32, **kw)


@pytest.mark.parametrize("seed", [0, 11])
def test_init_vit_params_with_head_matches_jax(seed):
    jspec, tspec = _tiny(2)
    want = jvit.init_vit_params(jax.random.key(seed), jspec)
    _compare_trees(tparams.init_vit_params(jr.key(seed), tspec), want, f"tiny+head seed {seed}")


def test_init_vit_params_b16_patch_embed_and_block0():
    """ViT-B/16's patch_embed and block 0, for the trunk of the shipped head
    file (trunk seed 0): JAX's init_vit_params at depth 1, which draws them
    as at depth 12 (test_split_does_not_depend_on_the_count)."""
    jspec, tspec = jvit.VitSpec(depth=1, dtype=jnp.float32), tvit.VitSpec(depth=1, dtype=torch.float32)
    want = jax.jit(jvit.init_vit_params, static_argnames="spec")(jax.random.key(0 ^ 0x5EED), jspec)
    _compare_trees(tparams.init_vit_params(tparams.trunk_key(0), tspec), want, "B/16")


def test_head_only_load_round_trip_matches_jax(tmp_path):
    """A head-only file written by the JAX package's save_params(trunk_seed)
    loads in the port as in JAX's load_or_init: the trunk regenerated from
    the trunk seed, the stored head attached; then resolve's checks and the
    inference cast."""
    jspec, tspec = _tiny(2)
    trained = jvit.init_vit_params(jax.random.key(42), jspec)  # stands for a trained head
    path = str(tmp_path / "head.npz")
    jparams.save_params(path, trained, trunk_seed=9)
    want = jparams.load_or_init(path, jspec)
    got = tparams.load_or_init(path, tspec)
    _compare_trees(got, want, "head-only load")
    np.testing.assert_array_equal(got["head"]["blocks"]["mlp"]["w2"].numpy(),
                                  np.asarray(trained["head"]["blocks"]["mlp"]["w2"]))
    cast_j = jparams.cast_for_inference(want, jspec._replace(dtype=jnp.bfloat16))
    cast_t = tparams.cast_for_inference(got, tspec._replace(dtype=torch.bfloat16))
    assert cast_t["head"]["blocks"]["attn"]["wqkv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        cast_t["head"]["blocks"]["attn"]["wqkv"].view(torch.int16).numpy(),
        np.asarray(cast_j["head"]["blocks"]["attn"]["wqkv"]).view(np.int16))
    assert "__trunk_seed__" not in got
    with open(path, "rb") as f:  # the file holds the head and the marker only
        names = np.load(f).files
    assert "__vpt_trunk_seed__" in names and not any(n.startswith("blocks") for n in names)
    assert json.loads(np.load(path)["__vpt_dtypes__"].tobytes().decode()) == {}
