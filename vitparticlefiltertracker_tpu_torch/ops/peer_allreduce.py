"""The "model" axis's all-reduce on the card: a peer-to-peer kernel and its
plain version.

A tensor-parallel ViT block (models/vit.py) ends each row-parallel product
with a sum over the "model" group of every rank's partial product, then the
bias. ``peer_all_reduce`` does that on the card through
csrc/peer_allreduce.cu: each rank's partial goes into a symmetric buffer that
every other rank of the group has mapped (CUDA IPC), and one kernel a call
sums the partials in rank order in f32, adds the bias and rounds once. A
small call takes the one-shot form (each rank sums every partial), a large
one the two-shot form (each rank sums its 1/m of the vectors, then gathers
the others' sums); ``peer_form`` chooses from the call's shape alone, so
every rank takes the same form, and both give the same bits. It
moves the data with plain loads and stores, so a CUDA graph's conditional
node may hold it: NCCL's collectives across cards do not capture there, and
the tracker step's lost-only branches are such nodes (ROADMAP.md §3, F6).
``peer_all_reduce_plain`` is the same function in plain PyTorch over the
partials gathered on the host's process group (the CPU's gloo ranks) and
in the comparisons. There is no fallback: on a CUDA tensor the kernel
launches or the call raises.

``PeerGroup`` holds one group's buffers: built collectively at mesh build
(parallel/mesh.py), outside any capture, with the cards' peer access
checked first (``check_peer_access``: a group over several nodes raises).
Its data buffer grows, collectively and never inside a capture, when a call
needs more room; an outgrown buffer is kept, because a graph captured
earlier holds its address. The buffers live as long as the process.
"""

from __future__ import annotations

import ctypes
import socket
from collections import Counter

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANKS = 8  # csrc/peer_allreduce.cu kMaxRanks: one node's NVLink domain
MAX_BLOCKS = 128  # kMaxBlocks
THREADS = 512  # kThreads
INITIAL_BYTES = 64 << 20  # the scan's [49, 196, 768] f32 partial and its f32 sum (two-shot) fit
HANDLE_BYTES = 64  # CUDA_IPC_HANDLE_SIZE


ONE_SHOT, TWO_SHOT = "one-shot", "two-shot"
_FORM_CODES = {ONE_SHOT: 0, TWO_SHOT: 1}
# The smallest call (f32 partial elements) that takes the two-shot form, by
# group size, from both forms timed on 4 x H100 (tools/port_mesh_check.py
# "peer", PERF.md section 6): on 2 cards two-shot first wins at
# [4, 196, 768] (0.0295 against 0.0302 ms), on 4 at [2, 196, 768] (0.0334
# against 0.0481 ms); other group sizes, unmeasured, take the 4-card value.
# Both keep a B 1 forward's calls ([1, 196, 768], [1, 196, 1024]) one-shot,
# the form that beats NCCL there on 2 cards.
TWO_SHOT_MIN_ELEMENTS = {2: 1 << 19}
TWO_SHOT_MIN_ELEMENTS_WIDE = 1 << 18


def launch_blocks(n: int) -> int:
    """The kernel's grid for n elements: a vector of 8 a thread, at most
    MAX_BLOCKS blocks (all resident at once: a block waits for the peers'
    blocks of its index)."""
    return max(1, min(MAX_BLOCKS, -(-(n // 8) // THREADS)))


def peer_form(n: int, m: int, x_dtype: torch.dtype) -> str:
    """The form of a call of n elements of x_dtype over a group of m: a
    function of these alone, so every rank of the group takes the same one.
    A one-rank group, a bf16 partial and a call under TWO_SHOT_MIN_ELEMENTS
    take the one-shot form (each rank reads every partial, two barriers); a
    larger f32 call the two-shot form (each rank reads 1/m of every partial
    and (m - 1)/m of the sums in the output dtype, three barriers)."""
    if m == 1 or x_dtype != torch.float32 or n < TWO_SHOT_MIN_ELEMENTS.get(m, TWO_SHOT_MIN_ELEMENTS_WIDE):
        return ONE_SHOT
    return TWO_SHOT


def form_blocks(n: int, m: int, form: str) -> int:
    """The grid of a call: launch_blocks over the whole call (one-shot) or
    over one rank's 1/m of it (two-shot: each thread reduces a vector of its
    rank's slice)."""
    return launch_blocks(n if form == ONE_SHOT else -(-(n // 8) // m) * 8)


def two_shot_ranges(n: int, m: int, blocks: int) -> list[list[tuple[int, int]]]:
    """The two-shot cut, as csrc/peer_allreduce.cu two_shot_range makes it:
    [rank r][block b] -> the vectors [lo, hi) of the n / 8 that block b
    reduces on rank r (and copies, and gathers, on every other rank)."""
    vecs = n // 8
    per_rank = -(-vecs // m)
    per_block = -(-per_rank // blocks)
    out = []
    for r in range(m):
        r_hi = min(per_rank * (r + 1), vecs)
        out.append([(min(per_rank * r + per_block * b, r_hi), min(per_rank * r + per_block * (b + 1), r_hi))
                    for b in range(blocks)])
    return out


def buffer_bytes(n: int, form: str, out_dtype: torch.dtype) -> int:
    """The symmetric buffer a call of n f32 elements needs: the partial
    (region A), and for the two-shot form the reduced slices in out_dtype
    after it (region B)."""
    return n * 4 + (n * out_dtype.itemsize if form == TWO_SHOT else 0)


def check_peer_access(infos: list, me: int, access) -> None:
    """Raise unless rank `me` can map every other rank's card. infos: each
    rank's (host name, PCI bus id of its card); access(bus id) -> 1 (the
    same card, or peer access), 0 (no peer access), -1 (not visible here).
    Two processes on one card pass (CUDA IPC works within a card)."""
    host, bus = infos[me]
    for p, (other_host, other_bus) in enumerate(infos):
        if p == me:
            continue
        if other_host != host:
            why = f"on another host ({other_host!r}, this rank's is {host!r})"
        elif other_bus == bus:
            continue
        else:
            ok = access(other_bus)
            if ok == 1:
                continue
            why = f"at {other_bus}, which {'this process cannot see' if ok < 0 else 'has no peer access'}"
        raise RuntimeError(
            f"the \"model\" group's all-reduce maps every rank's card through CUDA IPC over NVLink, and rank {p}'s "
            f"card is {why}; a \"model\" axis must stay within one node's peer-to-peer cards (ROADMAP.md §3, F6)")


def _lib():
    from vitparticlefiltertracker_tpu_torch.ops._build import peer_allreduce_library

    return peer_allreduce_library()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with code {rc}")


def _malloc(device: int, nbytes: int) -> int:
    ptr = ctypes.c_void_p()
    _check(_lib().vpt_par_malloc(device, nbytes, ctypes.byref(ptr)), f"vpt_par_malloc({nbytes})")
    return ptr.value


class PeerGroup:
    """The symmetric buffers of one "model" group of `m` ranks, this rank at
    index `me`, its card `device`: a flag array and a data buffer a rank,
    each mapped by every rank, and this rank's epoch counters. Built
    collectively over `group` (a torch.distributed group of those ranks, in
    index order) before any capture."""

    def __init__(self, group, me: int, m: int, device: torch.device):
        import torch.distributed as dist

        if m > MAX_RANKS:
            raise RuntimeError(f"a \"model\" group of {m} ranks: the peer all-reduce takes at most {MAX_RANKS} "
                               "(one node's cards; ROADMAP.md §3, F6)")
        lib = _lib()
        self.group, self.me, self.m, self.device = group, me, m, device
        dev = device.index
        bus = ctypes.create_string_buffer(32)
        _check(lib.vpt_par_bus_id(dev, bus, 32), "vpt_par_bus_id")
        infos = [None] * m
        dist.all_gather_object(infos, (socket.gethostname(), bus.value.decode()), group=group)

        def access(peer_bus: str) -> int:
            ok = ctypes.c_int()
            _check(lib.vpt_par_peer_access(dev, peer_bus.encode(), ctypes.byref(ok)), "vpt_par_peer_access")
            return ok.value

        check_peer_access(infos, me, access)
        self.buffers: list = []  # every allocation's pointers as mapped here, outgrown data buffers too
        self.epochs = _malloc(dev, MAX_BLOCKS * 8)
        self.flags = self._exchange(_malloc(dev, lib.vpt_par_flag_bytes()))
        self.data = (ctypes.c_void_p * m)()  # the data buffers (none on a one-rank group: the kernel reads x)
        self.capacity = 0
        if m > 1:
            self.reserve(INITIAL_BYTES)

    def _exchange(self, mine: int):
        """This rank's allocation `mine` -> a ctypes array of the group's
        allocations of that kind as this process maps them (every rank
        exports its handle and opens the others')."""
        import torch.distributed as dist

        lib = _lib()
        handle = ctypes.create_string_buffer(HANDLE_BYTES)
        _check(lib.vpt_par_ipc_handle(ctypes.c_void_p(mine), handle), "vpt_par_ipc_handle")
        handles = [None] * self.m
        dist.all_gather_object(handles, handle.raw, group=self.group)
        ptrs = (ctypes.c_void_p * self.m)()
        for p, h in enumerate(handles):
            if p == self.me:
                ptrs[p] = mine
                continue
            opened = ctypes.c_void_p()
            _check(lib.vpt_par_ipc_open(self.device.index, h, ctypes.byref(opened)), f"vpt_par_ipc_open (rank {p})")
            ptrs[p] = opened.value
        self.buffers.append(ptrs)
        return ptrs

    def reserve(self, nbytes: int) -> None:
        """Room for a partial of `nbytes` on every rank (collective: every
        rank makes the same calls, so every rank grows at the same one).
        Never inside a capture: the warm-up before each capture runs every
        call the capture holds."""
        if nbytes <= self.capacity:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the peer all-reduce needs {nbytes} B of buffer inside a graph capture (it has "
                               f"{self.capacity}): the capture's warm-up should have grown it")
        cap = max(nbytes, 2 * self.capacity)
        self.data = self._exchange(_malloc(self.device.index, cap))
        self.capacity = cap


def peer_all_reduce(x: torch.Tensor, bias: torch.Tensor, group: PeerGroup, form: str | None = None) -> torch.Tensor:
    """The sum over `group`'s ranks of each rank's `x` (this rank's partial:
    CUDA, contiguous, float32, or bfloat16 on a one-rank group), taken in
    f32 in rank order, plus `bias` ([x.shape[-1]], float32 or bfloat16),
    rounded once to bias's dtype -> a new tensor shaped as x. One launch of
    csrc/peer_allreduce.cu in the form `peer_form` picks (or `form`, which
    every rank must then pass alike: the comparisons run both); every rank
    of the group must make the same call. The last dimension and x.numel()
    are multiples of 8.

    Adds one to ``peer_all_reduce.launches`` (and to
    ``peer_all_reduce.shapes[(m, *x.shape)]``) a launch."""
    if not x.is_cuda:
        raise ValueError("peer_all_reduce takes CUDA tensors; use peer_all_reduce_plain on the CPU")
    if group is None:
        raise ValueError("peer_all_reduce needs the mesh's PeerGroup (a CUDA mesh builds one for \"model\")")
    out_dtype, d = bias.dtype, x.shape[-1]
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"peer_all_reduce takes float32 or bfloat16, got {x.dtype} and a {out_dtype} bias")
    if x.dtype == torch.bfloat16 and (out_dtype != torch.bfloat16 or group.m > 1):
        raise ValueError("bfloat16 partials only on a one-rank group into bfloat16: the sum of several is taken "
                         "from float32 partials")
    if x.numel() % 8 or d % 8:
        raise ValueError(f"peer_all_reduce needs x.numel() and the last dim as multiples of 8, got {tuple(x.shape)}")
    if bias.shape != (d,):
        raise ValueError(f"bias must be [{d}], got {tuple(bias.shape)}")
    form = form or peer_form(x.numel(), group.m, x.dtype)
    if form not in _FORM_CODES or (form == TWO_SHOT and (group.m == 1 or x.dtype != torch.float32)):
        raise ValueError(f"peer_all_reduce: no {form!r} form for a group of {group.m} over {x.dtype} partials "
                         "(two-shot takes float32 partials on 2 ranks or more)")
    x = x.contiguous()
    if bias.data_ptr() % 16 or not bias.is_contiguous():
        bias = bias.clone()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if group.m > 1:
        group.reserve(buffer_bytes(x.numel(), form, out_dtype))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vpt_par_allreduce(x.data_ptr(), _DTYPE_CODES[x.dtype], bias.data_ptr(),
                                   out.data_ptr(), _DTYPE_CODES[out_dtype], x.numel(), d,
                                   group.data, group.flags,
                                   group.m, group.me, group.epochs, form_blocks(x.numel(), group.m, form),
                                   _FORM_CODES[form], group.capacity, stream)
    if rc != 0:
        raise RuntimeError(f"vpt_par_allreduce failed with code {rc} at shape {tuple(x.shape)} (group of "
                           f"{group.m}, {form})")
    peer_all_reduce.launches += 1
    peer_all_reduce.shapes[(group.m, *x.shape)] += 1
    return out


peer_all_reduce.launches = 0
peer_all_reduce.shapes = Counter()


def peer_all_reduce_plain(parts: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version: parts [m, ...], rank p's partial at index p ->
    their f32 sum in rank order, plus bias, rounded once to bias's dtype."""
    acc = parts[0].float()
    for part in parts[1:]:
        acc = acc + part.float()
    return (acc + bias.float()).to(bias.dtype)
