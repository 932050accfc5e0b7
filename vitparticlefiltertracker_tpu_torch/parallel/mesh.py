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
counted whatever its axis's size; on an axis of 1 it moves nothing (a copy,
as NCCL does at one rank) and reaches no process group. With no mesh nothing
here touches a process group. The backend follows the device: NCCL for
CUDA tensors, gloo for CPU tensors.

The "model" axis's sums (``row_parallel_sum``) go, on a CUDA mesh, through
the port's peer-to-peer all-reduce kernel (ops/peer_allreduce.py,
csrc/peer_allreduce.cu) over buffers every rank of the group maps, built
with the mesh: NCCL's collectives across cards do not capture inside the
step graph's conditional nodes, whose bodies run ViT forwards. A "model"
group whose cards cannot map each other's memory (several nodes) raises at
mesh build. The partials are summed in f32 with the bias and rounded once.
On CPU
tensors (gloo ranks) the plain version sums the gathered partials. Each
mesh also holds two groups over all of its ranks for the streams
(runtime/streaming.py): ``all_group`` (NCCL on the card: the frames rank 0
reads, broadcast on the device) and ``host_group`` (gloo: the host's
control messages).
"""

from __future__ import annotations

import os
import tempfile
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from vitparticlefiltertracker_tpu_torch.ops.peer_allreduce import PeerGroup, peer_all_reduce, peer_all_reduce_plain

AXES = ("bank", "particle", "model")


class Mesh:
    """Named axes over the ranks of the default process group.

    axis_names, shape (axis -> size), coords (axis -> this rank's index),
    groups (axis -> the subgroup of this rank's line along that axis), rank
    (in the default group), backend, local_rank (the card a CUDA rank uses:
    cuda:local_rank), device, peers, all_group and host_group (see the
    module's docstring; None on a Mesh made without a process group)."""

    def __init__(self, axis_names, sizes, rank: int, groups: dict, backend: str, local_rank: int,
                 device: torch.device | None = None, peers=None, all_group=None, host_group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(rank, tuple(sizes)))))
        self.groups = groups
        self.backend = backend
        self.local_rank = local_rank
        # The device the mesh's tensors live on (NCCL: the rank's card).
        self.device = device if device is not None else _backend_device(backend, local_rank)
        self.peers = peers  # the "model" group's ops.peer_allreduce.PeerGroup (a CUDA mesh), else None
        self.all_group = all_group  # every rank of the mesh, the default backend
        self.host_group = host_group  # every rank of the mesh, gloo

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
    of the default process group (`what` names it in errors), its tensors
    on `device`: on CUDA the rank's card, cuda:LOCAL_RANK (by default the
    rank under NCCL, the current card under gloo), made current, and a
    "model" axis's peer-to-peer buffers (ops/peer_allreduce.py). A CUDA
    mesh over a gloo group (ranks sharing a card) may split "model" only:
    its other collectives would not capture."""
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
    everyone = [int(r) for r in ranks.reshape(-1)]
    all_group = dist.new_group(everyone)
    host_group = dist.new_group(everyone, backend="gloo")
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh ({what}) of {n} ranks")
    backend = dist.get_backend()
    cuda = torch.device(device).type == "cuda"
    if cuda and backend != "nccl" and any(s > 1 for a, s in zip(axis_names, sizes) if a != "model"):
        raise ValueError(f"a CUDA mesh over a {backend} group splits \"model\" only ({what})")
    local_rank = 0
    if cuda:
        local_rank = int(os.environ.get("LOCAL_RANK", rank if backend == "nccl" else torch.cuda.current_device()))
        torch.cuda.set_device(local_rank)
    dev = torch.device("cuda", local_rank) if cuda else torch.device("cpu")
    # One eager collective a group, in axis order on every rank: NCCL makes
    # a communicator at its first collective, which must not fall inside a
    # CUDA graph capture. Not counted.
    probe = torch.zeros(1, device=_backend_device(backend, local_rank))
    for group in (*(groups[name] for name in axis_names), all_group):
        dist.all_reduce(probe, group=group)
    peers = None
    if cuda and "model" in axis_names:
        peers = PeerGroup(groups["model"], int(np.unravel_index(rank, sizes)[axis_names.index("model")]),
                          sizes[axis_names.index("model")], dev)
    return Mesh(axis_names, sizes, rank, groups, backend, local_rank, dev, peers, all_group, host_group)


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
    if "mlp" in path and leaf in ("w1", "b1", "w12", "b12"):
        return -1  # w12, b12: [gate | up], each half cut alike (vit_param_shard)
    if "mlp" in path and leaf in ("w2", "w3"):
        return -2
    return None


def vit_param_shard(mesh: Mesh, params: dict) -> dict:
    """This rank's part of the ViT parameter tree under "model" tensor
    parallelism: wqkv, bqkv, mlp w1 and b1 cut along their last axis, wo and
    mlp w2 (w3) along their contraction axis, contiguous slice m of M (for the
    head-major fused QKV columns, heads [m H / M, (m + 1) H / M)); a SwiGLU
    FFN's w12 and b12 ([gate | up]) take slice m of the gate half and slice
    m of the up half, so the rank's [gate_m | up_m] pairs the same hidden
    columns that its rows of w3 read. Every other leaf (layer norms,
    embeddings, LayerScale gammas, the row-parallel biases) is the caller's
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
            elif k in ("w12", "b12"):
                part = v.shape[-1] // (2 * size)
                gate, up = v.chunk(2, dim=-1)
                out[k] = torch.cat([gate.narrow(-1, m * part, part), up.narrow(-1, m * part, part)], dim=-1)
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
    if mesh.shape[axis] == 1:
        out.copy_(x.reshape(-1))
    else:
        dist.all_gather_into_tensor(out, x.reshape(-1), group=mesh.groups[axis])
    _count(all_gather, axis, x)
    return out.view(mesh.shape[axis], *x.shape)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of `x` over this rank's `axis` line, written into `x`
    (contiguous) and returned."""
    if mesh.shape[axis] > 1:
        dist.all_reduce(x, group=mesh.groups[axis])
    _count(all_reduce, axis, x)
    return x


for _fn in (all_gather, all_reduce):
    _fn.launches = 0  # collectives issued (a graph replay adds its capture's)
    _fn.shapes = Counter()  # (axis, *shape) -> issued


def row_parallel_sum(y: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """y @ w + bias for a row-parallel weight (w: this rank's rows of it, y:
    this rank's columns of the input): every rank's partial product summed
    over "model" in rank order in f32, the bias added once and the sum
    rounded once to bias.dtype; every rank gets the same bits. On a
    one-rank group the partial is the product in y's dtype (so the sum is
    the unsharded block's `y @ w + bias` bit for bit: one bf16 add); on
    several ranks it is taken in f32 (torch.mm's out_dtype on the card), so
    no rank's share is rounded before the sum. CUDA: one launch of the peer
    kernel (ops/peer_allreduce.py); CPU: the plain version over the
    partials all-gathered on "model"."""
    if mesh.shape["model"] == 1 or y.dtype == torch.float32:
        part = y @ w
    elif y.is_cuda:
        part = torch.mm(y.reshape(-1, y.shape[-1]), w, out_dtype=torch.float32).view(*y.shape[:-1], w.shape[-1])
    else:
        part = y.float() @ w.float()
    if y.is_cuda:
        return peer_all_reduce(part, bias, mesh.peers)
    return peer_all_reduce_plain(all_gather(part, mesh, "model"), bias)
