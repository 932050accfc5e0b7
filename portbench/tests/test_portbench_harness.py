"""The harness on the CPU at a tiny size: a cell, a configuration, a
traffic mix and a per-layer metric added as new files alone are found and
run; what the run and the reference import."""

import json
import subprocess
import sys
import textwrap

from portbench import harness
from tiny import ROOT, make


def test_new_cell_configuration_traffic_and_metric_as_files_alone(tmp_path):
    bd = make(tmp_path, feeds=2, cell="tiny-cell")
    # A new per-layer metric: one file and one BENCHMARK.json entry.
    (bd / "metrics" / "records_per_s.py").write_text(textwrap.dedent('''
        def read(run):
            return len(run.in_window()) / run.seconds
    '''))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "records_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    wl, cfg = harness.cell_files("tiny-cell", bd)
    assert wl["feeds"] == 2 and cfg["name"] == "tiny-config"
    out = harness.run_cell("tiny-cell", 2**31 + 11, 1.5, False, "cpu", bench_dir=bd)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s", "records_per_s"}
    assert out["metrics"]["frames_per_s"]["value"] > 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["notes"]["compared"]["steps"] >= 2


def test_open_loop_traced_run(tmp_path):
    bd = make(tmp_path, feeds=1, loop="open", cell="tiny-live")
    out = harness.run_cell("tiny-live", 5, 1.5, True, "cpu", bench_dir=bd)
    assert out["correct"], out["checks"]
    assert "submit_ms_per_frame.live" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["attempted"] == 45  # 1.5 s at 30 frames/s


def _modules_after(code: str) -> set[str]:
    """Top-level names of the modules loaded after running `code` in a
    fresh interpreter at the checkout's root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    make(tmp_path, feeds=1, cell="tiny-cell")
    code = textwrap.dedent(f"""
        import torch
        torch.set_num_threads(1)
        from pathlib import Path
        from portbench import harness
        import portbench.run, portbench.control
        harness.run_cell("tiny-cell", 3, 1.0, False, "cpu", bench_dir=Path({str(tmp_path / 'portbench')!r}))
        assert not harness.forbidden_modules()
    """)
    names = _modules_after(code)
    assert "vitparticlefiltertracker_tpu_torch" in names  # the program under test ran
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_neither_jax_nor_the_program():
    names = _modules_after("import portbench.reference.step, portbench.reference.noise, portbench.weights\n"
                           "from portbench import harness\nharness.load_family('vit')")
    assert not names & {*harness.FORBIDDEN, "vitparticlefiltertracker_tpu_torch"}


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules({"vitparticlefiltertracker_tpu_torch.cli": 0, "jaxtyping": 0}) == []
    assert harness.forbidden_modules({"vitparticlefiltertracker_tpu.ops": 0, "jax.numpy": 0}) == [
        "jax.numpy", "vitparticlefiltertracker_tpu.ops"]
