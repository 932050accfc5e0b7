"""The port's benchmark harness (vitparticlefiltertracker_tpu_torch/
runtime/benchmark.py, utils/profiling.py, the `bench` command,
tools/port_bench_evals.py) against the JAX package's, on the CPU.

The FLOP count equals the JAX package's exactly on every config file; a
CPU run_benchmark returns the JAX package's keys with the same config
fields; the device-only parts (CUDA events, the H100 peak table) are checked
for what they give off the card. tests/test_torch_cuda.py runs the harness
on the card.
"""

import glob
import io
import json
import math
import os
from contextlib import redirect_stdout

import pytest
import test_torch_tracker_e2e  # noqa: F401  (one intra-op thread a test worker)
import torch

from chip_smoke import _bench_evals, _load_tool
from vitparticlefiltertracker_tpu.config import load_config as j_load_config
from vitparticlefiltertracker_tpu.runtime import benchmark as jbench
from vitparticlefiltertracker_tpu_torch.cli import main
from vitparticlefiltertracker_tpu_torch.config import Config, load_config
from vitparticlefiltertracker_tpu_torch.runtime import benchmark as tbench
from vitparticlefiltertracker_tpu_torch.utils import profiling

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIG_FILES = ["config.yaml"] + sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
# Crop mode (N crop forwards a frame) and banks (K window forwards) on top of
# config.yaml, and crop-mode banks.
OVERRIDES = {
    "crop": ["tracker.mode=crop", "tracker.crop_impl=window-pallas"],
    "banks8": ["runtime.banks=8"],
    "crop-banks8": ["tracker.mode=crop", "runtime.banks=8"],
    "pooled": ["tracker.appearance=pooled"],
}
TINY = {
    "model": {"variant": "vit-t16", "image_size": 64, "dtype": "float32", "use_flash_attention": False},
    "filter": {"num_particles": 64},
    "tracker": {"mode": "dense"},
    "io": {"source": "synthetic:moving-square", "frame_size": [96, 96]},
}
TINY_SETS = ["model.variant=vit-t16", "model.image_size=64", "model.dtype=float32",
             "model.use_flash_attention=false", "filter.num_particles=64", "io.frame_size=[96, 96]"]
SMALL = dict(warmup=1, measure_frames=10, latency_frames=4, stage_frames=2, verbose=False)
# The labels JAX's run_benchmark gives its device span off a device plane.
JAX_CPU_SOURCES = {"two_length_differencing", "two_length_differencing_invalid"}


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_flops_per_frame_equal_jax_on_every_config(name):
    path = os.path.join(ROOT, name)
    assert tbench.estimate_flops_per_frame(load_config(path)) == jbench.estimate_flops_per_frame(j_load_config(path))


@pytest.mark.parametrize("label", sorted(OVERRIDES))
def test_flops_per_frame_equal_jax_with_overrides(label):
    path = os.path.join(ROOT, "config.yaml")
    ov = OVERRIDES[label]
    mine = tbench.estimate_flops_per_frame(load_config(path, ov))
    assert mine == jbench.estimate_flops_per_frame(j_load_config(path, ov))
    assert mine != tbench.estimate_flops_per_frame(load_config(path))  # the override changes the count


def test_run_benchmark_on_cpu_returns_jax_keys():
    """The same tiny cfg through both harnesses on the CPU: the port's
    result holds every key of JAX's, the same config fields but backend,
    finite rates and times, a CPU device-span label of JAX's, no MFU."""
    from vitparticlefiltertracker_tpu.config import Config as JConfig

    want = jbench.run_benchmark(JConfig.from_dict(TINY), **SMALL)
    got = tbench.run_benchmark(Config.from_dict(TINY), device="cpu", **SMALL)
    assert set(want) <= set(got) and set(want["config"]) <= set(got["config"])
    assert {k: v for k, v in got["config"].items() if k not in ("backend", "device")} == \
        {k: v for k, v in want["config"].items() if k != "backend"}
    assert got["config"]["backend"] == "cpu" and got["config"]["device"] == "cpu"
    for key in ("fps", "fps_serving", "p50_ms", "p99_ms", "mean_ms", "rtt_ms"):
        assert math.isfinite(got[key]) and got[key] > 0, key
    assert got["p50_device_source"] in JAX_CPU_SOURCES
    assert want["p50_device_source"] in JAX_CPU_SOURCES
    assert got["mfu"] is None and got["peak_tflops"] is None and got["peak_basis"] is None
    assert got["est_gflops_per_frame"] == want["est_gflops_per_frame"]
    assert got["frames_measured"] == want["frames_measured"] == SMALL["measure_frames"]
    assert got["peak_memory_mib"] is None
    # warm-up 1, latency 4, differencing 2 + 8 + 16, serving 10, the clip
    # warm and 5 repeats of 2 frames.
    assert got["steps"] == 1 + 4 + 26 + 10 + 2 * 6


def test_run_benchmark_banked_on_cpu():
    """runtime.banks > 1 runs a MultiTracker over the tiled box; the FLOP
    count covers every bank."""
    cfg = Config.from_dict({**TINY, "runtime": {"banks": 3}})
    got = tbench.run_benchmark(cfg, device="cpu", **SMALL)
    assert got["config"]["banks"] == 3 and math.isfinite(got["fps"]) and got["fps"] > 0
    assert got["est_gflops_per_frame"] == round(tbench.estimate_flops_per_frame(cfg) / 1e9, 2)


def test_run_benchmark_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tbench.run_benchmark(Config.from_dict(TINY), **SMALL)


def test_bench_command_prints_one_json_line():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(["bench", "--device", "cpu", "--quiet", *(x for item in TINY_SETS for x in ("--set", item))])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["config"]["backend"] == "cpu" and result["frames_measured"] == 200
    assert result["p50_device_source"] in JAX_CPU_SOURCES


@pytest.mark.parametrize("name,dtype,tf32,want", [
    ("NVIDIA H100 80GB HBM3", "bfloat16", False, 989.0),
    ("NVIDIA H100 80GB HBM3", "float32", False, 67.0),
    ("NVIDIA H100 80GB HBM3", "float32", True, 495.0),
    ("NVIDIA H100 80GB HBM3", "bfloat16", True, 989.0),
    ("NVIDIA A100-SXM4-80GB", "bfloat16", False, None),
])
def test_peak_table(monkeypatch, name, dtype, tf32, want):
    """The H100 SXM basis by dtype (TF32 where torch allows it for f32
    products) on a card named H100; none on another card or the CPU."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    peak, basis = tbench.peak_tflops(dtype, torch.device("cuda"))
    assert peak == want
    assert (basis is None) == (want is None)
    if want:
        assert f"{want:g} TFLOP/s" in basis and "H100" in basis
    assert tbench.peak_tflops(dtype, torch.device("cpu")) == (None, None)


def test_profiled_step_device_ms_is_none_on_the_cpu():
    calls = []
    assert profiling.profiled_step_device_ms(calls.append, torch.device("cpu")) is None
    assert calls == []  # nothing is run on the CPU


def test_trace_off_and_on(tmp_path):
    with profiling.trace("") as prof:
        torch.ones(4).sum()
    assert prof is None
    out = tmp_path / "trace"
    with profiling.trace(str(out)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(out.glob("*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())["traceEvents"]
    # No CUDA event in a CPU-only trace.
    assert profiling.device_time_by_kernel(prof) == {}


def test_run_benchmark_traces_into_profile_dir(tmp_path):
    cfg = Config.from_dict({**TINY, "runtime": {"profile_dir": str(tmp_path)}})
    tbench.run_benchmark(cfg, device="cpu", **SMALL)
    assert len(list(tmp_path.glob("*.json"))) == 1


@pytest.mark.parametrize("i", [1, 2, 3, 4, 5])
def test_port_bench_evals_configs_are_the_files(i):
    """tools/port_bench_evals.py's dicts are the BASELINE config files, as
    both packages read them, with tools/bench_evals.py's counts."""
    path, _, stage, measure, _ = _bench_evals.EVALS[i - 1]
    assert (path, stage, measure) == _load_tool("bench_evals").EVALS[i - 1][:3]
    want = j_load_config(os.path.join(ROOT, path)).to_dict()
    assert load_config(os.path.join(ROOT, path)).to_dict() == want
    assert _bench_evals.config(i).to_dict() == want
