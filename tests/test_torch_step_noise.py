"""The step's noise drawn on the card (vitparticlefiltertracker_tpu_torch/
ops/step_noise.py, csrc/step_noise.cu) and the host's keys behind it
(runtime/tracker.py ``_GraphStepper._dispatch``).

On the CPU: the launch plan against torch's own formula worked by hand
(ATen/native/cuda/DistributionTemplates.h ``calc_execution_policy``), the
[K, 2] (seed, frame index) keys the host builds after init, a step, a chunk
and ``reinit_bank``, and the ``noise_host_draws`` counter. On the card
(marker ``cuda``; run with ``python -m pytest --noconftest -m cuda
tests/test_torch_step_noise.py``): the kernel's draws against torch's
generator bit for bit, the captured graph's noise after replays and a
``reinit_bank``, and graph steps against eager steps.
"""

import copy
import time

import numpy as np
import pytest
import torch

from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.filters import particle as tpf
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.ops import step_noise as sn
from vitparticlefiltertracker_tpu_torch.ops.image import FrameView, StreamFrame
from vitparticlefiltertracker_tpu_torch.runtime import banked
from vitparticlefiltertracker_tpu_torch.runtime import tracker as ttr
from vitparticlefiltertracker_tpu_torch.utils.profiling import SPANS

TINY = {
    "model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False},
    "filter": {"num_particles": 64},
    "tracker": {"mode": "dense"},
}

# Hand-worked from torch's formula for float draws on a card of 132 SMs with
# 2048 threads a SM (at most 132 * 2048 / 256 = 1056 blocks of 256):
#   grid = min(1056, ceil(numel / 256)),
#   offset step = ((numel - 1) // (256 * grid * 4) + 1) * 4,
# pos and vel draw 2 N floats, scale N, resample_u 1 (grid 1, step 4), in that
# order from offset 0; the reseed's 2 N from a generator of its own.
#   N 1:      2 / 256 -> grid 1;  1 -> 1;          steps 4, 4, 4
#   N 1000:   2000 / 256 = 7.8 -> 8;  1000 -> 4;    steps 4, 4, 4
#   N 1024:   2048 -> 8;  1024 -> 4
#   N 4096:   8192 -> 32;  4096 -> 16
#   N 300000: 600000 -> 2344 -> 1056; 300000 -> 1172 -> 1056;
#             599999 // (256 * 1056 * 4 = 1081344) = 0 -> step 4
#   N 600000: 1200000 -> 1056; 1199999 // 1081344 = 1 -> step 8 (two calls a
#             thread); 600000 -> 1056, step 4: offsets 0, 8, 16, 20
HAND_PLANS = {
    1: (1, 1, (0, 4, 8, 12, 0)),
    1000: (8, 4, (0, 4, 8, 12, 0)),
    1024: (8, 4, (0, 4, 8, 12, 0)),
    4096: (32, 16, (0, 4, 8, 12, 0)),
    300000: (1056, 1056, (0, 4, 8, 12, 0)),
    600000: (1056, 1056, (0, 8, 16, 20, 0)),
}
NS = sorted(HAND_PLANS)


@pytest.mark.parametrize("n", NS)
def test_draw_plan_matches_torchs_formula(n):
    """Each draw's grid and Philox offset at 132 SMs, as worked by hand."""
    assert tuple(sn.draw_plan(n, 132, 2048)) == HAND_PLANS[n]


@pytest.mark.parametrize("numel,sms,want", [
    (1, 132, (1, 4)), (256, 132, (1, 4)), (257, 132, (2, 4)),
    (1081344, 132, (1056, 4)), (1081345, 132, (1056, 8)), (3 * 1081344 + 1, 132, (1056, 16)),
    # 114 SMs (an H100 PCIe): 912 blocks at most, 933888 threads' float4s a pass
    (2000, 114, (8, 4)), (933888, 114, (912, 4)), (933889, 114, (912, 8)),
])
def test_launch_policy_at_the_grid_cap(numel, sms, want):
    """Below, at and past the full card's grid, where a thread starts to make
    a second float4 call and the offset step doubles."""
    assert sn.launch_policy(numel, sms, 2048) == want


@pytest.mark.parametrize("n,reseed,want", [
    (1024, False, 2 * 2048 + 1024 + 1), (1024, True, 3 * 2048 + 1024 + 1),
    (300000, False, 3 * 270336 + 1), (1, True, 2 + 2 + 1 + 1 + 2),
])
def test_work_items_are_the_threads_that_write(n, reseed, want):
    """A bank's work items: for each draw min(numel, 256 * grid) threads."""
    assert sn.work_items(n, sn.draw_plan(n, 132, 2048), reseed) == want
    assert sn.launch_blocks(16 * want, 132) == min(-(-16 * want // 256), 1056)


def _spy_draws(monkeypatch) -> list:
    """Record each draw_step_noise call the tracker makes: (seeds, frame indices)."""
    calls = []
    orig = ttr.draw_step_noise

    def spy(seed, idx, n, device, dtype=torch.float32):
        calls.append((list(seed), list(idx)))
        return orig(seed, idx, n, device, dtype)

    monkeypatch.setattr(ttr, "draw_step_noise", spy)
    return calls


def _chunk(src, first: int, c: int, roi: int = 128) -> StreamFrame:
    """Frames first .. first + c - 1 as a ROI chunk (a crop of `roi` px at
    the origin) over the first frame's global view at stride 2."""
    frames = src.frames[first:first + c]
    pixels = torch.from_numpy(np.stack([np.ascontiguousarray(f[:roi, :roi]) for f in frames]))
    glob = FrameView(torch.from_numpy(np.ascontiguousarray(frames[0][::2, ::2])), torch.zeros(2), 2.0)
    return StreamFrame(FrameView(pixels, torch.zeros((c, 2)), 1.0), glob)


def test_host_keys_follow_init_steps_chunks_and_reinit(monkeypatch):
    """The [K, 2] int64 keys the dispatch builds (before any copy), and the
    host draws made from them on the CPU (graphs off): a Tracker after init,
    a step and a chunk of 3 (frame index + c for step c); a MultiTracker of
    3 banks after init, a step, reinit_bank(1) with a negative seed (bank 1
    back at frame index 0, the others untouched) and a step."""
    calls = _spy_draws(monkeypatch)
    cfg = Config.from_dict(copy.deepcopy(TINY))
    s = int(cfg.filter.seed)
    src = open_source("synthetic:moving-square", num_frames=8, frame_size=(128, 128))
    tr = ttr.Tracker(copy.deepcopy(cfg), device="cpu")
    tr.init(src.frames[0], src.init_bbox)
    keys = tr._noise_keys()
    assert not tr.graphs and keys.dtype == np.int64 and keys.tolist() == [[s, 0]]
    tr.step_packed(torch.from_numpy(src.frames[1]))
    assert calls[-1] == ([s], [0]) and tr._noise_keys().tolist() == [[s, 1]]
    tr.step_chunk_packed(_chunk(src, 2, 3))
    assert calls[-1] == ([s] * 3, [1, 2, 3]) and tr._noise_keys().tolist() == [[s, 4]]

    bcfg = Config.from_dict({**copy.deepcopy(TINY), "runtime": {"banks": 3}})
    boxes = banked.banked_bboxes(src.init_bbox, 3)
    mt = banked.MultiTracker(bcfg, device="cpu")
    mt.init(src.frames[0], boxes)
    assert mt._noise_keys().tolist() == [[s, 0], [s + 1, 0], [s + 2, 0]]
    mt.step_packed(torch.from_numpy(src.frames[1]))
    assert calls[-1] == ([s, s + 1, s + 2], [0, 0, 0])
    mt.reinit_bank(1, src.frames[1], boxes[1], seed=-7)
    assert mt._noise_keys().tolist() == [[s, 1], [-7, 0], [s + 2, 1]]
    mt.step_packed(torch.from_numpy(src.frames[2]))
    assert calls[-1] == ([s, -7, s + 2], [1, 0, 1])
    assert mt._noise_keys().tolist() == [[s, 2], [-7, 1], [s + 2, 2]]


@pytest.mark.parametrize("kind", ["frames", "multistream", "roi-chunk"])
def test_noise_host_draws_counts_the_cpu_banks(kind):
    """stream_track reports noise_host_draws: on the CPU a bank a frame,
    every feed of a multi-stream dispatch and every frame of a chunk."""
    from test_torch_spans import _stream

    stats, _ = _stream(kind)
    frames = sum(c * n for c, n in stats["dispatches"].items())
    assert frames > 0
    assert stats["noise_host_draws"] == frames * (2 if kind == "multistream" else 1)


def test_noise_host_draws_counts_each_step_and_chunk():
    """A step of K banks counts K; a chunk of C frames counts C."""
    src = open_source("synthetic:moving-square", num_frames=6, frame_size=(128, 128))
    tr = ttr.Tracker(Config.from_dict(copy.deepcopy(TINY)), device="cpu")
    tr.init(src.frames[0], src.init_bbox)
    before = SPANS.totals()
    tr.step_packed(torch.from_numpy(src.frames[1]))
    tr.step_chunk_packed(_chunk(src, 2, 4))
    assert SPANS.totals().since(before)["counts"].get("noise_host_draws") == 5
    mt = banked.MultiTracker(Config.from_dict({**copy.deepcopy(TINY), "runtime": {"banks": 3}}), device="cpu")
    mt.init(src.frames[0], banked.banked_bboxes(src.init_bbox, 3))
    before = SPANS.totals()
    mt.step_packed(torch.from_numpy(src.frames[1]))
    assert SPANS.totals().since(before)["counts"].get("noise_host_draws") == 3


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal float32 tensors (-0 and +0 differ; NaN payloads count)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _nan_buffers(per: tuple, n: int, dev, reseed: bool):
    """Noise buffers shaped as a graph's (and the reseed's), NaN-filled so an
    element the kernel misses shows."""
    nan = float("nan")
    noise = tpf.StepNoise(torch.full((*per, n, 2), nan, device=dev), torch.full((*per, n, 2), nan, device=dev),
                          torch.full((*per, n), nan, device=dev), torch.full(per, nan, device=dev))
    return noise, (torch.full((*per, n, 2), nan, device=dev) if reseed else None)


def _check_against_torch(noise, reseed, seeds, frames, n, dev, per) -> None:
    """Every bank's buffers against draw_step_noise / draw_reseed_noise of
    its (seed, frame index) on the card, bit for bit."""
    want = tpf.draw_step_noise(seeds, frames, n, dev)
    for name, got, ref in zip(tpf.StepNoise._fields, noise, want):
        assert _same_bits(got, ref.reshape((*per, *ref.shape[1:]))), name
    if reseed is not None:
        assert _same_bits(reseed, tpf.draw_reseed_noise(seeds, frames, n, dev).reshape((*per, n, 2))), "reseed"


@pytest.mark.cuda
@pytest.mark.parametrize("seed0", [-5, 123456789])
@pytest.mark.parametrize("frame", [0, 1, 2**31 - 1])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", [1, 16])
def test_kernel_draws_equal_torchs_bitwise(cuda_device, k, n, frame, seed0):
    """K banks' step noise and reseed normals in one launch, each bank's
    equal to torch's generator keyed on its (seed, frame index): seeds
    seed0 + 1000003 i (bank 0 negative for seed0 -5), frame indices
    frame + i % 3."""
    seeds = [seed0 + 1000003 * i for i in range(k)]
    frames = [frame + i % 3 for i in range(k)]
    keys = torch.tensor(list(zip(seeds, frames)), dtype=torch.int64, device=cuda_device)
    noise, reseed = _nan_buffers((k,), n, cuda_device, True)
    before = sn.step_noise.launches
    sn.step_noise(keys, noise, reseed)
    torch.cuda.synchronize()
    assert sn.step_noise.launches == before + 1
    _check_against_torch(noise, reseed, seeds, frames, n, cuda_device, (k,))


@pytest.mark.cuda
@pytest.mark.parametrize("per,k", [((), 1), ((4,), 1), ((4, 3), 3)], ids=["one-filter", "chunk-4", "chunk-4x3"])
@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("reseed", [False, True])
def test_kernel_fills_single_and_chunk_buffers(cuda_device, per, k, n, reseed):
    """The buffers a one-filter graph (no leading axis) and a chunk graph of
    C = 4 steps ([4, ...], and [4, K, ...] over K banks) hold: step c of
    bank k draws (seed_k, frame_k + c); without re-detection no reseed."""
    seeds, frames = [-(2**40) - 3 + 17 * i for i in range(k)], [2**31 - 2 + i for i in range(k)]
    keys = torch.tensor(list(zip(seeds, frames)), dtype=torch.int64, device=cuda_device)
    noise, rs = _nan_buffers(per, n, cuda_device, reseed)
    sn.step_noise(keys, noise, rs)
    torch.cuda.synchronize()
    c = int(np.prod(per, dtype=np.int64)) // k
    _check_against_torch(noise, rs, seeds * c, [f + i for i in range(c) for f in frames], n, cuda_device, per)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    """Keys not [K, 2] int64, buffers of other shapes or dtypes, and a bank
    count that K does not divide raise before any launch."""
    noise, rs = _nan_buffers((3,), 8, cuda_device, True)
    keys = torch.zeros((3, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        sn.step_noise(keys.int(), noise, rs)
    with pytest.raises(ValueError):
        sn.step_noise(torch.zeros((2, 2), dtype=torch.int64, device=cuda_device), noise, rs)
    with pytest.raises(ValueError):
        sn.step_noise(keys, noise._replace(scale=noise.scale.double()), rs)
    with pytest.raises(ValueError):
        sn.step_noise(keys, noise, rs[:, :4])
    with pytest.raises(ValueError):
        sn.step_noise(keys.cpu(), noise, rs)


@pytest.mark.cuda
def test_graph_noise_follows_the_host_keys_after_replays_and_reinit(cuda_device):
    """A MultiTracker of 3 banks with re-detection (the graph draws the
    reseed normals too): after 5 replays, and after reinit_bank(1) with a
    negative seed and one more replay, the graph's noise buffers equal the
    eager draws for the host's (seed, frame index) of the step, and its key
    buffer holds those keys; then one replay of the graph called directly
    (as a timing tool does, which no host key follows) and a step_packed:
    that step still draws the host's keys."""
    import chip_smoke

    d = copy.deepcopy(chip_smoke.TINY_BANKED_REDETECT)
    d["runtime"] = {"banks": 3}
    cfg = Config.from_dict(d)
    src = open_source(cfg.io.source, cfg.io.num_frames, tuple(cfg.io.frame_size))
    boxes = banked.banked_bboxes(src.init_bbox, 3)
    tr = banked.MultiTracker(cfg, device="cuda")
    tr.init(src.frames[0], boxes)
    (sg,) = tr._step_graphs.values()
    assert sg.reseed is not None and tuple(sg.keys.shape) == (3, 2)
    n = cfg.filter.num_particles

    def step_and_check(frame) -> None:
        keys = tr._noise_keys()
        tr.step_packed(torch.from_numpy(frame).cuda())
        torch.cuda.synchronize()
        assert sg.keys.cpu().tolist() == keys.tolist() and tr._noise_keys().tolist() == (keys + [0, 1]).tolist()
        _check_against_torch(sg.noise, sg.reseed, keys[:, 0].tolist(), keys[:, 1].tolist(), n, cuda_device, (3,))

    for f in src.frames[1:6]:
        tr.step_packed(torch.from_numpy(f).cuda())
    assert tr._noise_keys()[:, 1].tolist() == [5, 5, 5]
    step_and_check(src.frames[6])
    tr.reinit_bank(1, src.frames[6], boxes[1], seed=-11)
    assert tr._noise_keys().tolist()[1] == [-11, 0]
    step_and_check(src.frames[7])
    sg.replay()
    step_and_check(src.frames[8])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["single", "banked"])
def test_eight_graph_steps_equal_eager_steps_bitwise(cuda_device, kind):
    """Eight step_packed rows through the graphs (noise drawn on the card)
    against the eager step (the host's torch.Generator draws), bit for bit:
    one filter with the head, its automatic blend and re-detection, and 3
    banks with re-detection. The graph tracker counts no host draw."""
    import chip_smoke

    d = copy.deepcopy(chip_smoke.TINY_HEAD_REDETECT if kind == "single" else chip_smoke.TINY_BANKED_REDETECT)
    if kind == "banked":
        d["runtime"] = {"banks": 3}
    cfg = Config.from_dict(d)
    src = open_source(cfg.io.source, 9, tuple(cfg.io.frame_size))
    prm = ttr.Tracker(copy.deepcopy(cfg), device="cpu").vit_params
    rows, draws = {}, {}
    for graphs in (False, True):
        if kind == "single":
            tr = ttr.Tracker(copy.deepcopy(cfg), vit_params=prm, device="cuda", graphs=graphs)
            tr.init(src.frames[0], src.init_bbox)
        else:
            tr = banked.MultiTracker(copy.deepcopy(cfg), prm, "cuda", graphs)
            tr.init(src.frames[0], banked.banked_bboxes(src.init_bbox, 3))
        before = SPANS.totals()
        rows[graphs] = torch.stack([tr.step_packed(torch.from_numpy(f).cuda()) for f in src.frames[1:9]]).cpu()
        draws[graphs] = SPANS.totals().since(before)["counts"].get("noise_host_draws", 0)
    assert _same_bits(rows[True], rows[False])
    banks = 1 if kind == "single" else 3
    assert draws == {False: 8 * banks, True: 0}


@pytest.mark.cuda
def test_key_hand_off_waits_for_nothing(cuda_device):
    """The keys reach the graph without the host waiting for the card: with
    about a second of work queued ahead on the stream, a step_packed
    returns long before that work ends (a copy from pageable memory would
    wait for it), after a step and after reinit_bank; the card's keys then
    equal those the host held for that step."""
    import chip_smoke

    d = copy.deepcopy(chip_smoke.TINY)
    d["runtime"] = {"banks": 2}
    cfg = Config.from_dict(d)
    src = open_source(cfg.io.source, 5, tuple(cfg.io.frame_size))
    boxes = banked.banked_bboxes(src.init_bbox, 2)
    tr = banked.MultiTracker(cfg, device="cuda")
    tr.init(src.frames[0], boxes)
    (sg,) = tr._step_graphs.values()
    frames = [torch.from_numpy(f).cuda() for f in src.frames[1:5]]
    tr.step_packed(frames[0])
    for i, change in enumerate((None, 1, None)):
        if change is not None:
            tr.reinit_bank(change, src.frames[0], boxes[change], seed=-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(2_000_000_000)  # about a second of cycles
        keys = tr._noise_keys()
        tr.step_packed(frames[i + 1])
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        assert host_s < 0.25 < wall_s, (i, host_s, wall_s)
        assert sg.keys.cpu().tolist() == keys.tolist()
    s = int(cfg.filter.seed)
    assert tr._noise_keys().tolist() == [[s, 4], [-3, 2]]
