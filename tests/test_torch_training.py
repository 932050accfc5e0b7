"""Port parity: feature training (vitparticlefiltertracker_tpu_torch/training/
data.py, objective.py, train.py's optimizer) against the JAX package's
training/ on the same inputs.

The JAX package draws its scenes and per-pair draws from jax.random keys;
the helpers below rebuild those draws from the same keys exactly as
training/data.py and training/objective.py split them, and the port renders
and scores them. Tolerances are stated where they are used: the scene's
geometry to 1e-4 px and its pixels to 5e-3 on the 0-255 scale (jax.image's
resize weights against F.interpolate's, and transcendental functions, round
differently); the loss to rtol 1e-4 and the parameters after an update to
atol 2e-5, as tests/test_training.py holds its sharded step to the plain one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch

from vitparticlefiltertracker_tpu.config import Config as JConfig
from vitparticlefiltertracker_tpu.models.params import _flatten as jflatten
from vitparticlefiltertracker_tpu.training import data as jdata
from vitparticlefiltertracker_tpu.training import objective as jobj
from vitparticlefiltertracker_tpu.training import probe as jprobe
from vitparticlefiltertracker_tpu.training import train as jtrain
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.models.params import _flatten
from vitparticlefiltertracker_tpu_torch.training import data as tdata
from vitparticlefiltertracker_tpu_torch.training import objective as tobj
from vitparticlefiltertracker_tpu_torch.training import probe as tprobe
from vitparticlefiltertracker_tpu_torch.training import train as ttrain

GEOM_TOL_PX = 1e-4
PIXEL_TOL = 5e-3  # 0..255 scale
LOSS_RTOL = 1e-4  # as tests/test_training.py:117-119
PARAM_ATOL = 2e-5  # as tests/test_training.py:120-122
GRAD_TOL = 2e-5  # f32 gradients of the tiny model, whose leaves are O(0.1-1)


def tiny_train_dict(**train_over):
    """tests/test_training.py's tiny_train_cfg as a dict; model keys in
    `model` (head_depth) go to the model section."""
    model = {"variant": "custom", "depth": 2, "dim": 64, "heads": 2, "mlp_dim": 128, "patch_size": 16,
             "image_size": 64, "dtype": "float32", "use_flash_attention": False}
    model.update(train_over.pop("model", {}))
    train = {"steps": 8, "batch_size": 4, "canvas": 96, "window": 64, "lr": 1e-3, "warmup": 2, "log_every": 4,
             "checkpoint_out": ""}
    train.update(train_over)
    return {"model": model, "train": train}


def jax_scene_draws(key, batch: int, size: int, look_frac=0.35, blur_prob=0.0, blur_sigma=1.2) -> dict:
    """SceneDraws' fields (numpy) from a JAX key, as make_pair_batch splits
    it (training/data.py:131-267): each value a jax.random call returns, a
    draw compared with a probability as the outcome."""
    s = float(size)
    u, n = jax.random.uniform, jax.random.normal

    def one(key):
        ks = jax.random.split(key, 18)
        d = {
            "grid0": u(ks[0], (10, 10, 3), minval=25.0, maxval=215.0),
            "grid1": u(ks[1], (40, 40, 3), minval=-18.0, maxval=18.0),
            "log_w": u(ks[2], (), minval=jnp.log(10.0), maxval=jnp.log(56.0)),
            "log_aspect": u(ks[3], (), minval=jnp.log(0.15), maxval=jnp.log(1.3)),
            "p0": u(ks[4], (2,), minval=0.22 * s, maxval=0.78 * s),
            "delta": n(ks[5], (2,)),
            "colors_t": u(ks[6], (3, 3), minval=0.0, maxval=235.0),
            "colors_d": u(ks[7], (3, 3), minval=0.0, maxval=235.0),
            "d_on": u(ks[8], ()) < 0.7,
            "n_dpos": n(ks[9], (2,)),
            "n_dwh": n(ks[10], (2,)),
            "n_drift": n(ks[11], (2,)),
            "cam": n(ks[12], (2,)),
            "n_tgain": n(ks[13], ()),
            "occ_on": u(ks[14], ()) < 0.25,
            "u_occ_x": u(ks[15], (), minval=-0.8, maxval=0.8),
            "occ_color": u(ks[16], (3,), minval=40.0, maxval=160.0),
            "n_gain": n(ks[17], ()),
        }
        k_lk, k_lr, k_la, k_lkk = jax.random.split(jax.random.fold_in(key, 55), 4)
        d.update(look_on=u(k_lk, ()) < look_frac, look_r=u(k_lr, (), minval=1.3, maxval=2.3),
                 look_th=u(k_la, (), minval=0.0, maxval=2.0 * jnp.pi), look_k5=u(k_lkk, ()) < 0.5)
        k_sp, k_a0, k_da, k_wide = jax.random.split(jax.random.fold_in(key, 77), 4)
        d.update(spokes=u(k_sp, ()) < 0.5, ang0=u(k_a0, (), minval=0.0, maxval=2.0 * jnp.pi),
                 u_dang=u(k_da, (), minval=-1.0, maxval=1.0), wide=u(k_wide, ()) < 0.3)
        if blur_prob > 0.0:
            k_bl, k_bs = jax.random.split(jax.random.fold_in(key, 131), 2)
            d.update(blur_on=u(k_bl, ()) < blur_prob, blur_sigma=u(k_bs, (), minval=0.3, maxval=blur_sigma))
        k_noise0, k_noise1, k_bias, k_cg = jax.random.split(jax.random.fold_in(key, 99), 4)
        d.update(n_ch_gain=n(k_cg, (3,)), bias=u(k_bias, (), minval=-26.0, maxval=26.0),
                 noise0=n(k_noise0, (size, size, 3)), noise1=n(k_noise1, (size, size, 3)),
                 noise2=n(jax.random.fold_in(key, 111), (size, size, 3)))
        return d

    return {k: np.array(v) for k, v in jax.vmap(one)(jax.random.split(key, batch)).items()}


def scene_draws(d: dict) -> tdata.SceneDraws:
    return tdata.SceneDraws(**{f: torch.from_numpy(d[f]) if f in d else None for f in tdata.SceneDraws._fields})


def jax_loss_draws(keys, num_random: int, n_cloud: int) -> tobj.LossDraws:
    """LossDraws from the per-pair keys, as pair_loss splits them
    (training/objective.py:73-100)."""
    def one(key):
        k_jit, k_rand, k_cloud = jax.random.split(key, 3)
        return (jax.random.normal(k_jit, (2,)), jax.random.uniform(k_rand, (num_random, 2), minval=-0.4, maxval=0.4),
                jax.random.normal(k_cloud, (n_cloud, 2)))

    return tobj.LossDraws(*(torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys)))


def scene_batch(jb) -> tdata.SceneBatch:
    return tdata.SceneBatch(*(torch.from_numpy(np.array(x)) for x in jb))


def loss_kw(cfg) -> dict:
    tr = cfg.train
    return dict(tau=tr.tau, search_scale=cfg.tracker.search_scale, num_random=tr.num_random_negatives,
                template_jitter=tr.template_jitter, cloud_weight=tr.cloud_weight,
                cloud_particles=tr.cloud_particles, cloud_sigma=tr.cloud_sigma, cloud_zscale=tr.cloud_zscale,
                distractor_margin=tr.distractor_margin, distractor_weight=tr.distractor_weight,
                distractor_centered_weight=tr.distractor_centered_weight,
                distractor_absent_weight=tr.distractor_absent_weight)


def jax_step_inputs(cfg, step: int):
    """The JAX step's batch and per-pair keys at `step` (train.py:122-136),
    and the same as the port's SceneBatch and LossDraws."""
    tr = cfg.train
    k = jax.random.fold_in(jax.random.key(tr.seed ^ 0x7A11), step)
    jb = jdata.make_pair_batch(jax.random.fold_in(k, 0), tr.batch_size, tr.canvas, tr.lookalike_frac, tr.blur_prob,
                               tr.blur_sigma)
    keys = jax.random.split(jax.random.fold_in(k, 1), tr.batch_size)
    n_cloud = tr.cloud_particles if tr.cloud_weight > 0.0 else 0
    return jb, keys, scene_batch(jb), jax_loss_draws(keys, tr.num_random_negatives, n_cloud)


def _np_tree(tree) -> dict:
    return {k: np.asarray(v) for k, v in jflatten(jax.device_get(tree)).items()}


# -- the scene generator -------------------------------------------------------


@pytest.mark.parametrize("blur_prob", [0.0, 0.5])
def test_render_scene_from_jax_draws_matches_make_pair_batch(blur_prob):
    key = jax.random.key(3)
    want = jdata.make_pair_batch(key, 6, 96, 0.6, blur_prob, 1.2)
    got = tdata.render_scene(scene_draws(jax_scene_draws(key, 6, 96, 0.6, blur_prob, 1.2)), 96, blur_prob)
    for f in ("p0", "p1", "wh", "d1", "look_on"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=GEOM_TOL_PX,
                                   err_msg=f)
    for f in ("frame0", "frame1", "frame2"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape == (6, 96, 96, 3)
        np.testing.assert_allclose(g, w, rtol=0, atol=PIXEL_TOL, err_msg=f)
    if blur_prob > 0.0:
        assert 0 < int(np.sum(jax_scene_draws(key, 6, 96, 0.6, blur_prob, 1.2)["blur_on"])) < 6  # both branches ran


@pytest.mark.parametrize("cells", [10, 40])
def test_octave_matches_jax(cells):
    key = jax.random.key(cells)
    want = np.asarray(jdata._octave(key, 288, cells, 25.0, 215.0))
    grid = np.array(jax.random.uniform(key, (cells, cells, 3), minval=25.0, maxval=215.0))
    got = tdata._octave(torch.from_numpy(grid)[None], 288)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PIXEL_TOL)


@pytest.mark.parametrize("sigma", [0.3, 1.0, 1.2])
def test_sep_blur_matches_jax(sigma):
    img = np.random.default_rng(0).uniform(0, 255, (2, 32, 24, 3)).astype(np.float32)
    on = np.array([1.0, 0.0], np.float32)
    got = tdata._sep_blur(torch.from_numpy(img), torch.full((2,), sigma), torch.from_numpy(on)).numpy()
    for i in range(2):
        want = np.asarray(jdata._sep_blur(jnp.asarray(img[i]), jnp.float32(sigma), jnp.float32(on[i])))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-4)
    assert np.array_equal(got[1], img[1])


def test_blur_clip_matches_jax():
    clip = np.random.default_rng(1).integers(0, 255, (3, 16, 20, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tprobe._blur_clip(clip, 1.0), jprobe._blur_clip(clip, 1.0))


def test_ring_offsets_match_jax():
    np.testing.assert_allclose(tobj.ring_offsets().numpy(), np.asarray(jobj.ring_offsets()), rtol=0, atol=1e-6)


# -- the objective: loss, metrics and gradients --------------------------------

CASES = {
    "full": {},
    "freeze-prefix-1": {"freeze_prefix": 1},
    "head-2": {"model": {"head_depth": 2}, "lookalike_frac": 0.6, "blur_prob": 0.5},
}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_case(request):
    """One case's configs, JAX's initial parameters, the step-0 inputs and
    jax.value_and_grad of JAX's batch_loss there, its freeze mask applied."""
    d = tiny_train_dict(**copy.deepcopy(CASES[request.param]))
    jcfg, tcfg = JConfig.from_dict(d), Config.from_dict(d)
    init_fn, _ = jtrain.build_train_step(jcfg)
    jp, _ = init_fn()
    es = jtrain._train_embed_spec(jcfg)
    jb, keys, tb, draws = jax_step_inputs(jcfg, 0)
    kw = loss_kw(jcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(lambda p: jobj.batch_loss(p, es, jb, keys, **kw),
                                                        has_aux=True))(jp)
    freeze = jtrain._freeze_mask_fn(jcfg)
    if freeze is not None:
        grads = freeze(grads)
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg, "params": jp, "batch": tb, "draws": draws,
            "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()}, "grads": _np_tree(grads)}


def test_init_matches_jax_bitwise(jax_case):
    init_fn, _ = ttrain.build_train_step(jax_case["tcfg"], "cpu")
    params, _ = init_fn()
    want = _np_tree(jax_case["params"])
    got = _flatten(params)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and np.array_equal(v.detach().numpy(), want[k]), k


def test_batch_loss_and_grads_match_jax(jax_case):
    init_fn, step_fn = ttrain.build_train_step(jax_case["tcfg"], "cpu")
    params, _ = init_fn()
    loss, metrics, grads = step_fn.grads(params, 0, jax_case["batch"], jax_case["draws"])
    np.testing.assert_allclose(float(loss), jax_case["loss"], rtol=LOSS_RTOL)
    assert set(metrics) == set(jax_case["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), jax_case["metrics"][k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    want = jax_case["grads"]
    trained = {k for k, g in want.items() if np.any(g != 0)}
    # The port differentiates the trained leaves only; JAX's frozen ones are zero.
    assert trained <= set(grads)
    if jax_case["name"] == "head-2":
        assert all(k.startswith("head/") for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0, atol=GRAD_TOL, err_msg=k)
    if jax_case["name"] == "freeze-prefix-1":
        assert all(not np.any(g[0].numpy()) for k, g in grads.items() if k.startswith("blocks/"))


def test_optimizer_fed_jax_grads_matches_optax(jax_case):
    """Three updates from JAX's gradients, through JAX's chain (freeze, clip,
    AdamW with its mask and schedule, freeze) and through TrainOptimizer:
    update 0 at rate 0, update 1 from gradients scaled under the clip's
    norm, update 2 over it."""
    jcfg = jax_case["jcfg"]
    tx, freeze = jtrain.build_optimizer(jcfg.train), jtrain._freeze_mask_fn(jcfg)
    jp = jax_case["params"]
    state = tx.init(jp)
    init_fn, _ = ttrain.build_train_step(jax_case["tcfg"], "cpu")
    params, opt = init_fn()
    grads_tree = _unflatten_like(jp, jax_case["grads"])
    for i, scale in enumerate((1.0, 1e-3, 1.0)):
        g = jax.tree.map(lambda x: x * scale, grads_tree)
        if freeze is not None:
            g = freeze(g)
        updates, state = tx.update(g, state, jp)
        if freeze is not None:
            updates = freeze(updates)
        before = _np_tree(jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.update({k: torch.from_numpy(v * np.float32(scale)) for k, v in jax_case["grads"].items()
                           if k in opt.leaves})
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-5)
        assert (float(norm) < 1.0) == (scale < 1.0)
        want, got = _np_tree(jp), _flatten(params)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=0, atol=PARAM_ATOL, err_msg=f"update {i}: {k}")
            if i == 0:
                assert np.array_equal(v.detach().numpy(), before[k]), k  # rate 0 at update 0


def _unflatten_like(tree, flat: dict, prefix: str = ""):
    return {k: _unflatten_like(v, flat, f"{prefix}{k}/") if isinstance(v, dict) else jnp.asarray(flat[f"{prefix}{k}"])
            for k, v in tree.items()}


@pytest.mark.parametrize("steps,warmup", [(8, 2), (6000, 300), (3, 5), (10, 0)])
def test_lr_schedule_matches_optax(steps, warmup):
    d = tiny_train_dict(steps=steps, warmup=warmup, lr=4e-4)
    tr = Config.from_dict(d).train
    want = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=tr.lr, warmup_steps=tr.warmup,
                                              decay_steps=max(tr.steps, tr.warmup + 1), end_value=tr.lr * 0.05)
    lr = ttrain.lr_schedule(tr)
    assert lr(0) == 0.0 or warmup == 0
    for c in sorted({0, 1, warmup, warmup + 1, steps // 2, steps - 1, steps, steps + 7}):
        np.testing.assert_allclose(lr(c), float(want(c)), rtol=1e-5, atol=1e-12, err_msg=str(c))


def test_decay_mask_matches_jax():
    d = tiny_train_dict(model={"head_depth": 1})
    jp, _ = jtrain.build_train_step(JConfig.from_dict(d))[0]()
    params, opt = ttrain.build_train_step(Config.from_dict(d), "cpu")[0]()
    assert ttrain._decay_mask(params) == jtrain._decay_mask(jp)
    decayed = {id(p) for g in opt.adamw.param_groups if g["weight_decay"] > 0 for p in g["params"]}
    for k, v in _flatten(params).items():
        if v.requires_grad:
            assert (id(v) in decayed) == (k.rsplit("/", 1)[-1] in ttrain._DECAY_LEAVES), k
