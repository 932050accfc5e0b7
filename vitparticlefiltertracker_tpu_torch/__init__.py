"""PyTorch / CUDA port of vitparticlefiltertracker_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package keeps its
module layout and names. It imports torch and numpy only. Entry points run
on CUDA unless the caller passes ``device="cpu"``; on a CUDA tensor the
port's kernels run (csrc/), on a CPU tensor their plain PyTorch versions do.
"""

__version__ = "0.1.0"

from vitparticlefiltertracker_tpu_torch.config import Config, load_config

# The heavier entry points resolve lazily (PEP 562), so that importing the
# package stays cheap: Tracker, MultiTracker, MultiStreamTracker,
# stream_track, open_source.
_LAZY = {
    "Tracker": ("vitparticlefiltertracker_tpu_torch.runtime.tracker", "Tracker"),
    "MultiTracker": ("vitparticlefiltertracker_tpu_torch.runtime.banked", "MultiTracker"),
    "MultiStreamTracker": ("vitparticlefiltertracker_tpu_torch.runtime.banked", "MultiStreamTracker"),
    "stream_track": ("vitparticlefiltertracker_tpu_torch.runtime.streaming", "stream_track"),
    "open_source": ("vitparticlefiltertracker_tpu_torch.io.video", "open_source"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Config", "load_config", "__version__", *sorted(_LAZY)]
