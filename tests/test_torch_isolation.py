"""The port stands alone: with jax, ml_dtypes, yaml, cv2, imageio and the
JAX package made unimportable, every module of
vitparticlefiltertracker_tpu_torch (parallel/ included) and chip_smoke.py
imports, and the tracker runs two CPU steps, also on a one-rank gloo mesh
(cv2 and imageio are imported only inside the readers and the overlay sink
that use them)."""

import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "yaml", "orbax", "cv2", "imageio", "vitparticlefiltertracker_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import vitparticlefiltertracker_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from vitparticlefiltertracker_tpu_torch.config import Config
from vitparticlefiltertracker_tpu_torch.io.video import open_source
from vitparticlefiltertracker_tpu_torch.runtime.tracker import Tracker
cfg = Config.from_dict(chip_smoke.TINY)
src = open_source(cfg.io.source, 3, tuple(cfg.io.frame_size))
recs = list(Tracker(cfg, device="cpu").run(src))
assert len(recs) == 2, recs
# The head, its automatic blend and global re-detection, with the weights
# from the port's own threefry (models/jax_random.py).
from vitparticlefiltertracker_tpu_torch.models import jax_random
assert jax_random.split(jax_random.key(0), 2)[1] == jax_random.fold_in(jax_random.key(0), 1)
cfg = Config.from_dict(chip_smoke.TINY_HEAD_REDETECT)
src = open_source(cfg.io.source, 6, tuple(cfg.io.frame_size))
recs = list(Tracker(cfg, device="cpu").run(src))
assert len(recs) == 5, recs
# The mesh (parallel/): one gloo rank, a (1, 1, 1) mesh, its collectives issued.
assert "vitparticlefiltertracker_tpu_torch.parallel.mesh" in names
import torch.distributed
from vitparticlefiltertracker_tpu_torch.parallel import mesh as pm
cfg = Config.from_dict(chip_smoke.TINY)
src = open_source(cfg.io.source, 3, tuple(cfg.io.frame_size))
recs = list(Tracker(cfg, device="cpu", mesh=pm.make_mesh(1, 1, 1, device="cpu")).run(src))
assert len(recs) == 2 and pm.all_gather.launches == 2 and pm.all_reduce.launches > 0, recs
torch.distributed.destroy_process_group()
loaded = [m for m in ("jax", "ml_dtypes", "yaml", "cv2", "imageio", "vitparticlefiltertracker_tpu")
          if sys.modules.get(m) is not None]
assert not loaded, loaded
print("OK", len(names))
"""


def test_port_imports_and_runs_without_jax_or_yaml():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 20  # every module was walked


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # on the card the script runs; tests/test_torch_cuda.py covers that
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


PUBLIC = ("Config", "load_config", "Tracker", "MultiTracker", "MultiStreamTracker", "stream_track", "open_source")


def _fresh(code: str) -> subprocess.CompletedProcess:
    """`code` in a new interpreter at the repo's root (no test module loaded)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_package_exports_the_public_names():
    """The JAX package's seven public names, on the port's package; the
    heavier five resolve lazily to the port's own objects."""
    import vitparticlefiltertracker_tpu_torch as pkg
    from vitparticlefiltertracker_tpu_torch.runtime.streaming import stream_track

    assert all(hasattr(pkg, name) for name in PUBLIC)
    assert pkg.stream_track is stream_track and pkg.Tracker.__module__.startswith(pkg.__name__)
    assert set(PUBLIC) <= set(pkg.__all__)


def test_package_import_loads_neither_yaml_nor_jax():
    proc = _fresh("import sys\nimport vitparticlefiltertracker_tpu_torch as p\ncfg = p.Config()\n"
                  "print(sorted(m for m in ('yaml', 'jax', 'vitparticlefiltertracker_tpu') if m in sys.modules))")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


def test_streaming_imports_nothing_of_the_jax_package():
    proc = _fresh("import sys\nimport vitparticlefiltertracker_tpu_torch.runtime.streaming\n"
                  "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'yaml'\n"
                  "             or m.split('.')[0] == 'vitparticlefiltertracker_tpu'))")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
