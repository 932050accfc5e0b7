"""The device mesh over ``torch.distributed`` — the port of the JAX package's
``parallel/mesh.py``.

One process runs per rank (``torchrun`` on the cards, ``torch.multiprocessing``
in the tests). A ``Mesh`` names the axes ("bank", "particle", "model") of the
JAX package's device mesh, lays the ranks out as JAX lays out its devices
(``reshape(banks, particles, model)``, so rank = (b * P + p) * M + m) and
holds one process subgroup per axis: the ranks that differ from this one
along that axis only.

- **bank**: independent filter banks (MultiTracker, MultiStreamTracker): rank
  b holds banks ``bank_slice``; the packed outputs are all-gathered.
- **particle**: the single filter's per-particle scoring (the fused cell
  scorer, or K2 and one ViT forward on a crop each) runs on a contiguous
  N / P slice a rank, and its results are all-gathered; the filter update
  after it runs on the full vectors on every rank.
- **model**: Megatron tensor parallelism of the ViT (``vit_param_shard``): a
  rank holds H / M heads and mlp_dim / M hidden columns, and the row-parallel
  products are all-reduced before their bias.

Where XLA inserts the collectives from sharding annotations, the port issues
them itself, through the functions below, which count their calls as the
kernel wrappers count their launches (runtime/step_graph.py counts them in
a captured step as it counts K1 and K2). With a mesh every collective is
issued whatever its axis's size: an axis of 1 is not short-circuited. With
no mesh nothing here touches a process group. The backend follows the
device: NCCL for CUDA tensors, gloo for CPU tensors.
"""

from __future__ import annotations

import os
import tempfile
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

AXES = ("bank", "particle", "model")


class Mesh:
    """Named axes over the ranks of the default process group.

    axis_names, shape (axis -> size), coords (axis -> this rank's index),
    groups (axis -> the subgroup of this rank's line along that axis), rank
    (in the default group), backend, and local_rank (the card a CUDA rank
    uses: cuda:local_rank)."""

    def __init__(self, axis_names, sizes, rank: int, groups: dict, backend: str, local_rank: int):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(rank, tuple(sizes)))))
        self.groups = groups
        self.backend = backend
        self.local_rank = local_rank

    def __repr__(self) -> str:
        axes = " x ".join(f"{self.shape[a]} {a}" for a in self.axis_names)
        return f"Mesh({axes}; rank {self.rank} at {self.coords}, {self.backend})"


def init_distributed(device="cuda", store: str | None = None) -> None:
    """Initialise the default process group if it is not yet: from the
    environment ``torchrun`` sets (RANK, WORLD_SIZE, MASTER_ADDR, ...), or,
    without it or when `store` names a file, a group of one process over
    that file store (by default one in a fresh temporary directory). NCCL
    for a CUDA device (the rank's card is cuda:LOCAL_RANK, made current),
    gloo for the CPU."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if store is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        store = store or os.path.join(tempfile.mkdtemp(prefix="vpt_mesh_"), "store")
        dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1)


def _backend_device(backend: str, local_rank: int) -> torch.device:
    return torch.device("cuda", local_rank) if backend == "nccl" else torch.device("cpu")


def build_mesh(axis_names: tuple[str, ...], sizes: tuple[int, ...], device, what: str) -> Mesh:
    """A mesh of the named axes and sizes over the first prod(sizes) ranks
    of the default process group (`what` names it in errors). On NCCL the
    rank's card, cuda:LOCAL_RANK, is made current."""
    init_distributed(device)
    world = dist.get_world_size()
    n = int(np.prod(sizes, dtype=np.int64))
    if n > world:
        raise ValueError(f"mesh ({what}) needs {n} devices, have {world}")
    rank = dist.get_rank()
    ranks = np.arange(n).reshape(sizes)
    groups = {}
    # Every rank creates every group, in the same order (new_group is a
    # collective of the default group).
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, sizes[ax])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh ({what}) of {n} ranks")
    backend = dist.get_backend()
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if backend == "nccl" else 0
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    mesh = Mesh(axis_names, sizes, rank, groups, backend, local_rank)
    # One eager collective a group, in axis order on every rank: NCCL makes
    # a communicator at its first collective, which must not fall inside a
    # CUDA graph capture. Not counted.
    probe = torch.zeros(1, device=_backend_device(backend, local_rank))
    for name in axis_names:
        dist.all_reduce(probe, group=groups[name])
    return mesh


def make_mesh(banks: int = 1, particles: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A ("bank", "particle", "model") mesh over the first banks * particles
    * model ranks of the default group (initialised for `device` if it is
    not yet: NCCL for "cuda", gloo for "cpu"). Raises ValueError when the
    mesh needs more ranks than there are."""
    return build_mesh(AXES, (banks, particles, model), device,
                       f"{banks} bank x {particles} particle x {model} model")


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor n into (bank, particle), favouring the particle axis, the axis
    that grows in this domain (the JAX package's rule)."""
    bank = 1
    for cand in (2, 4, 8):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            bank = cand
            break
    if n_devices % bank:
        bank = 1
    return bank, n_devices // bank


def check_tp_divisibility(heads: int, mlp_dim: int, model_axis: int) -> None:
    if heads % model_axis or mlp_dim % model_axis:
        raise ValueError(
            f"tensor-parallel axis {model_axis} must divide model.heads "
            f"({heads}) and model.mlp_dim ({mlp_dim})"
        )


def _tp_axis(path: tuple[str, ...], leaf: str) -> int | None:
    """The axis a tensor-parallel leaf is split along (the JAX package's
    vit_param_sharding specs), or None for a replicated leaf."""
    if "attn" in path and leaf in ("wqkv", "bqkv"):
        return -1  # column-parallel: heads, head-major (h, 3, hd) columns
    if "attn" in path and leaf == "wo":
        return -2  # row-parallel
    if "mlp" in path and leaf in ("w1", "b1"):
        return -1
    if "mlp" in path and leaf == "w2":
        return -2
    return None


def vit_param_shard(mesh: Mesh, params: dict) -> dict:
    """This rank's part of the ViT parameter tree under "model" tensor
    parallelism: wqkv, bqkv, mlp w1 and b1 cut along their last axis, wo and
    mlp w2 along their contraction axis, contiguous slice m of M (for the
    head-major fused QKV columns, heads [m H / M, (m + 1) H / M)); every other
    leaf (layer norms, embeddings, the row-parallel biases) is the caller's
    tensor. Applies to the depth-stacked blocks and the residual head's."""
    m, size = mesh.coords["model"], mesh.shape["model"]

    def walk(tree: dict, path: tuple[str, ...]) -> dict:
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, (*path, k))
                continue
            ax = _tp_axis(path, k)
            if ax is None or size == 1:
                out[k] = v
            else:
                part = v.shape[ax] // size
                out[k] = v.narrow(ax, m * part, part).contiguous()
        return out

    return walk(params, ())


def bank_slice(mesh: Mesh, k: int, what: str = "runtime.banks") -> slice:
    """The banks of this rank's "bank" index: a contiguous K / B of K
    (`what` names K in the ValueError when B does not divide it)."""
    b, size = mesh.coords["bank"], mesh.shape["bank"]
    if k % size:
        raise ValueError(f"{what} {k} must divide by runtime.mesh_banks {size}")
    per = k // size
    return slice(b * per, (b + 1) * per)


# -- collectives, counted ------------------------------------------------------

def _count(fn, axis: str, x: torch.Tensor) -> None:
    fn.launches += 1
    fn.shapes[(axis, *x.shape)] += 1


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[...] on each rank of this rank's `axis` line -> [size, ...], rank i's
    at index i."""
    out = torch.empty(mesh.shape[axis] * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=mesh.groups[axis])
    _count(all_gather, axis, x)
    return out.view(mesh.shape[axis], *x.shape)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of `x` over this rank's `axis` line, written into `x`
    (contiguous) and returned."""
    dist.all_reduce(x, group=mesh.groups[axis])
    _count(all_reduce, axis, x)
    return x


for _fn in (all_gather, all_reduce):
    _fn.launches = 0  # collectives issued (a graph replay adds its capture's)
    _fn.shapes = Counter()  # (axis, *shape) -> issued
