"""The port's kernel build (vitparticlefiltertracker_tpu_torch/ops/_build.py):
a library is named by a hash of its source and of the local headers the
source includes, so that editing a shared header rebuilds every library
that includes it. No compiler is needed."""

import shutil
import subprocess
from pathlib import Path

from vitparticlefiltertracker_tpu_torch.ops import _build

SOURCES = ("flash_attn.cu", "window_patchify.cu")
HEADER = "mma_sm90.cuh"
# nvcc -Xptxas -v's report, in its format.
REPORT = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z7spilledv' for 'sm_90a'
ptxas info    : Function properties for _Z7spilledv
    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z5cleanv' for 'sm_90a'
ptxas info    : Function properties for _Z5cleanv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 98 registers, used 1 barriers"""


def test_both_kernels_include_the_shared_header():
    for name in SOURCES:
        assert _build._local_headers(_build.CSRC_DIR / name) == [_build.CSRC_DIR / HEADER]


def test_editing_a_header_changes_the_hash_of_every_source_that_includes_it(tmp_path):
    for name in (*SOURCES, HEADER):
        shutil.copy(_build.CSRC_DIR / name, tmp_path / name)
    before = {name: _build._source_hash(tmp_path / name) for name in SOURCES}
    assert before == {name: _build._source_hash(tmp_path / name) for name in SOURCES}  # stable
    header = tmp_path / HEADER
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {name: _build._source_hash(tmp_path / name) for name in SOURCES}
    assert all(after[name] != before[name] for name in SOURCES)


def test_a_missing_header_is_left_to_the_compiler(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "absent.cuh"\n#include <cuda_runtime.h>\n')
    assert _build._local_headers(src) == []
    assert len(_build._source_hash(src)) == 16


def test_chip_smoke_reads_registers_and_spills_from_the_ptxas_report():
    """chip_smoke.py fails a build whose K2 kernels spill; it reads that from
    nvcc's -Xptxas -v report, in this format."""
    import chip_smoke

    assert chip_smoke.ptxas_functions(REPORT) == {
        "_Z7spilledv": {"spill_stores": 16, "spill_loads": 24, "registers": 128},
        "_Z5cleanv": {"spill_stores": 0, "spill_loads": 0, "registers": 98},
    }


def test_a_cached_library_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """The report is saved beside the library and read back when the
    library is cached, so a cached build's spills can still be checked; a
    library without its report is built again. nvcc and the loader are
    stand-ins here."""
    compiles = []

    def nvcc(cmd, **_):
        compiles.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", REPORT)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)

    def build():
        monkeypatch.setattr(_build, "_LOADED", {})
        return _build.build_library("window_patchify.cu")[1]

    first = build()
    assert first["built"] and first["ptxas"] == REPORT and len(compiles) == 1
    assert Path(first["so"]).with_suffix(".ptxas.txt").read_text() == REPORT
    cached = build()
    assert not cached["built"] and cached["ptxas"] == REPORT and len(compiles) == 1
    Path(first["so"]).with_suffix(".ptxas.txt").unlink()
    again = build()
    assert again["built"] and again["ptxas"] == REPORT and len(compiles) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [Path(first["so"]).name, Path(first["so"]).with_suffix(".ptxas.txt").name])
