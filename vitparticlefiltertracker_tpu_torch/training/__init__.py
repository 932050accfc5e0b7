"""Feature training: learn the ViT's appearance features — the port of the
JAX package's ``training/``.

  * data.py      — the procedural scene-pair generator, on the device
  * objective.py — the localization InfoNCE through models/embedder.py, the
                   tracker's own dense embedding path
  * probe.py     — the tracking probe that selects the checkpoint
  * train.py     — the AdamW loop and the checkpoint it writes

Run with ``python -m vitparticlefiltertracker_tpu_torch train --config
configs/train-head.yaml`` (config section ``train:``). The names below
resolve lazily (PEP 562), as the package's own do.
"""

_LAZY = {
    "SceneBatch": ("vitparticlefiltertracker_tpu_torch.training.data", "SceneBatch"),
    "make_pair_batch": ("vitparticlefiltertracker_tpu_torch.training.data", "make_pair_batch"),
    "train_features": ("vitparticlefiltertracker_tpu_torch.training.train", "train_features"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_LAZY)
