"""Build and load the port's CUDA kernels: ``nvcc`` into a plain-C shared
library, loaded with ``ctypes``.

No PyTorch headers and no ``torch.utils.cpp_extension``: the sources have an
``extern "C"`` interface, so one ``nvcc`` call per source takes seconds. The
library goes to ``_build/`` inside the package (listed in ``.gitignore``),
named by a hash of its source and of the local headers it includes, so a
process builds it at most once and an unchanged source is not rebuilt.
nvcc's ptxas report is kept beside it, so that a cached library's
registers and spills can still be checked. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# name -> (ctypes.CDLL, build record); one entry per source per process.
_LOADED: dict[str, tuple[ctypes.CDLL, dict]] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda/bin)")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _local_headers(src: Path, seen: set[Path] | None = None) -> list[Path]:
    """The headers ``src`` includes with quotes from its own directory, and
    theirs in turn, each once, sorted."""
    seen = set() if seen is None else seen
    for name in _LOCAL_INCLUDE.findall(src.read_text()):
        header = src.parent / name
        if header.exists() and header not in seen:
            seen.add(header)
            _local_headers(header, seen)
    return sorted(seen)


def _source_hash(src: Path) -> str:
    """Names the library: the source, its local headers and the target."""
    h = hashlib.sha256(src.read_bytes())
    for header in _local_headers(src):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library(source: str) -> tuple[ctypes.CDLL, dict]:
    """Compile ``csrc/<source>`` (if its hashed .so is missing) and load it.

    Returns (library, record) where record holds the .so path, whether this
    call compiled it, the seconds the compile took and nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills), read back from beside a
    cached library. A library without its report is built again.
    """
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC_DIR / source
    stem = Path(source).stem
    so = BUILD_DIR / f"libvpt_{stem}_{_source_hash(src)}.so"
    report = so.with_suffix(".ptxas.txt")
    record = {"source": str(src.relative_to(PKG_DIR.parent)), "so": str(so),
              "built": False, "seconds": 0.0, "ptxas": ""}
    if so.exists() and report.exists():
        record["ptxas"] = report.read_text()
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for old in (*BUILD_DIR.glob(f"libvpt_{stem}_*.so"), *BUILD_DIR.glob(f"libvpt_{stem}_*.ptxas.txt")):
            old.unlink()  # keep only the current source's library and report
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        record["seconds"] = time.perf_counter() - t0
        record["ptxas"] = proc.stderr.strip()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stdout}\n{proc.stderr}"
            )
        tmp_report = report.with_suffix(f".{os.getpid()}.tmp")
        tmp_report.write_text(record["ptxas"])
        os.replace(tmp_report, report)  # the report first: a library never stands without it
        os.replace(tmp, so)
        record["built"] = True
    lib = ctypes.CDLL(str(so))
    _LOADED[source] = (lib, record)
    return lib, record


def build_libraries(sources: list[str]) -> dict[str, tuple[ctypes.CDLL, dict]]:
    """build_library for each source, the nvcc processes all started together
    (one thread each; the compiles run in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build_library, sources)))


def flash_attn_library() -> ctypes.CDLL:
    """The attention kernel's library, with argtypes set (pointers and the
    stream as c_void_p, so 64-bit addresses are not cut to 32 bits)."""
    lib, _ = build_library("flash_attn.cu")
    fn = lib.vpt_flash_attn_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, o, strides (12 int64), b, h, t, d, dtype, scale, path, warps, grid, stream
        fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i,
                       ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.vpt_flash_attn_smem_bytes.argtypes = [i, i, i, i]
        lib.vpt_flash_attn_smem_bytes.restype = ctypes.c_int
    return lib


def window_patchify_library() -> ctypes.CDLL:
    """The fused window gather+patchify+embed kernel's library (K2), with
    argtypes set as for flash_attn_library."""
    lib, _ = build_library("window_patchify.cu")
    fn = lib.vpt_window_patchify_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # window, centers, sizes, kernel, bias, out, n, swin, c, crop, patch,
        # d, dtype, path, grid_x, grid_y, stream
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.vpt_window_patchify_smem_bytes.argtypes = [i, i, i, i]
        lib.vpt_window_patchify_smem_bytes.restype = ctypes.c_int
    return lib


def graph_if_library() -> ctypes.CDLL:
    """The CUDA graph IF-node helpers of a captured step
    (runtime/step_graph.py), with argtypes set as for flash_attn_library."""
    lib, _ = build_library("graph_if.cu")
    if lib.vpt_if_begin.argtypes is None:
        p = ctypes.c_void_p
        lib.vpt_if_begin.argtypes = [p, p, p]  # capturing stream, predicate, body stream
        lib.vpt_if_begin.restype = ctypes.c_int
        lib.vpt_if_end.argtypes = [p]
        lib.vpt_if_end.restype = ctypes.c_int
        lib.vpt_if_load.argtypes = []
        lib.vpt_if_load.restype = ctypes.c_int
    return lib


def peer_allreduce_library() -> ctypes.CDLL:
    """The "model" group's peer-to-peer all-reduce and its buffer helpers
    (ops/peer_allreduce.py), with argtypes set as for flash_attn_library."""
    lib, _ = build_library("peer_allreduce.cu")
    if lib.vpt_par_allreduce.argtypes is None:
        p, i, ll, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p
        pp = ctypes.POINTER(ctypes.c_void_p)
        # x, x dtype, bias, out, out dtype, n, d, data[m], flags[m], m, me, epochs, blocks, form, capacity,
        # stream
        lib.vpt_par_allreduce.argtypes = [p, i, p, p, i, ll, ll, pp, pp, i, i, p, i, i, ll, p]
        lib.vpt_par_malloc.argtypes = [i, ll, pp]
        lib.vpt_par_free.argtypes = [p]
        lib.vpt_par_ipc_handle.argtypes = [p, cp]
        lib.vpt_par_ipc_open.argtypes = [i, cp, pp]
        lib.vpt_par_ipc_close.argtypes = [p]
        lib.vpt_par_bus_id.argtypes = [i, cp, i]
        lib.vpt_par_peer_access.argtypes = [i, cp, ctypes.POINTER(ctypes.c_int)]
        lib.vpt_par_flag_bytes.restype = ll
        for fn in (lib.vpt_par_allreduce, lib.vpt_par_malloc, lib.vpt_par_free, lib.vpt_par_ipc_handle,
                   lib.vpt_par_ipc_open, lib.vpt_par_ipc_close, lib.vpt_par_bus_id, lib.vpt_par_peer_access):
            fn.restype = i
    return lib


def step_noise_library() -> ctypes.CDLL:
    """The step noise kernel's library (ops/step_noise.py), with argtypes
    set as for flash_attn_library."""
    lib, _ = build_library("step_noise.cu")
    fn = lib.vpt_step_noise
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # keys, c, k, n, pos, vel, scale, u, reseed, grid2, grid1, off_vel, off_scale, off_u, blocks, stream
        fn.argtypes = [p, i, i, ll, p, p, p, p, p, i, i, ll, ll, ll, i, p]
        fn.restype = i
    return lib


def swiglu_library() -> ctypes.CDLL:
    """The SwiGLU gate kernel's library (ops/swiglu.py), with argtypes set
    as for flash_attn_library."""
    lib, _ = build_library("swiglu.cu")
    fn = lib.vpt_swiglu
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x, out, m, h, dtype, blocks, stream
        fn.argtypes = [p, p, ll, ll, i, i, p]
        fn.restype = i
    return lib


def prenorm_junction_library() -> ctypes.CDLL:
    """The pre-norm junction kernel's library (ops/prenorm_junction.py), with
    argtypes set as for flash_attn_library."""
    lib, _ = build_library("prenorm_junction.cu")
    fn = lib.vpt_prenorm_junction
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x, branch, bias, scale, shift, x_new, y, m, d, dtype, eps, vpl, warps, blocks, stream
        fn.argtypes = [p, p, p, p, p, p, p, ll, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = i
    return lib
