// Peer-to-peer all-reduce of a tensor-parallel ViT block's row-parallel
// products over the mesh's "model" group, on the cards of one node.
//
// Replaces no TPU kernel: in the JAX package XLA's partitioner inserts this
// sum. The port first used NCCL's all-reduce, which does not capture inside
// a CUDA graph's conditional (IF) node when the group spans cards, and the
// tracker step's lost-only branches (the probe and the re-detection scan) are
// IF nodes whose bodies run a ViT forward. This kernel moves the data with
// plain loads and stores over NVLink (cudaIpc-mapped peer memory), so a
// conditional body can hold it like any other kernel node.
//
// One launch a call, in one of two forms, chosen on the host by a function
// of (n, m, the partial's dtype) alone (ops/peer_allreduce.py peer_form), so
// every rank of the group takes the same one.
//
// One-shot (small calls: a B 1 forward's [1, 196, 768]):
//   1. each block copies its slice of this rank's partial (f32, or the model
//      dtype on a one-rank group) into this rank's symmetric buffer;
//   2. a start barrier: the block signals its slice written to every peer
//      (a release store into the peer's flag for this block and this rank)
//      and waits for every peer's flag (acquire loads);
//   3. the block reads the slice from every rank, sums it in f32 in rank
//      order 0..m-1 (so every rank computes the same bits), adds the bias in
//      f32 and rounds once to the output dtype;
//   4. an end barrier (the same handshake on a second set of flags): every
//      peer has read the slice, so the next call may write the buffer again.
// Each rank reads (m - 1) whole partials over NVLink.
//
// Two-shot (large calls: the re-detection scan's [49, 196, 768]): the n / 8
// vectors are cut into m slices, rank r owning slice r, and every slice into
// one piece a block; block b owns the same piece of each slice on every rank,
// so the per-block barriers cover what each block reads.
//   1. block b copies its pieces of the other ranks' slices of this rank's
//      f32 partial into region A of its symmetric buffer; start barrier;
//   2. block b reduces its piece of this rank's slice: it reads the piece
//      from every rank (this rank's from the partial itself) in rank order
//      0..m-1, sums in f32, adds the bias and rounds once to the output
//      dtype, as the one-shot form, and writes the result to `out` and to
//      region B (n * 4 bytes in) of its buffer; a second barrier;
//   3. block b gathers the other ranks' reduced pieces from their region B,
//      in the output dtype (bf16 halves the gather's bytes), into `out`;
//   4. an end barrier on a third set of flags: every peer has read both
//      regions before this rank's next call writes them. (Without it a rank
//      could start a call, or exit, while a peer still gathers from it: the
//      next call may have another n, so region A would overlap the old
//      region B, and a one-shot call writes its buffer before any barrier.)
// Each element is summed in the same order and rounded once in both forms,
// so they are bitwise equal to each other and to the plain version. Each
// rank reads (m - 1) / m of a partial and (m - 1) / m of the output over
// NVLink, where the one-shot form reads m - 1 partials: on 4 cards into bf16
// the bytes of 1.125 partials against 3, for one more barrier.
//
// The barrier's value is an epoch that the kernel itself advances, one
// counter a block index in this rank's memory: a replayed graph passes the
// same arguments every time, so no host value can count the calls. Every
// rank makes the same calls in the same order (the ranks hold bitwise-equal
// state, so they take the same branches), and the form and the grid are
// functions of the call's shape, so a block's epoch is the same on every
// rank at each call. A wait longer than kTimeoutNs traps (the context fails
// instead of spinning forever when a peer never makes the call). Peers'
// memory is read through L2 only (ld.global.cg): L1 is not coherent with a
// peer's stores.
//
// Bound: the bytes that cross NVLink at 450 GB/s each way a card; a one-shot
// call of one [1, 196, 768] f32 partial is about 2 us of transfer, so the
// two barriers' round trips (a few us each) weigh as much. The grid is at
// most kMaxBlocks blocks, all resident at once (a block waits on the peers'
// blocks of the same index), each thread moving 16-byte vectors of 8
// elements, several in flight: all m partials of a vector in the sum, four
// vectors in the copies.
//
// Plain C interface, loaded with ctypes (ops/_build.py); the buffers are
// allocated, exported and mapped by the functions below (cudaMalloc,
// cudaIpcGetMemHandle, cudaIpcOpenMemHandle), never by a graph's pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRanks = 8;     // one node's NVLink domain
constexpr int kMaxBlocks = 128;  // <= the SMs: every block resident at once
constexpr int kThreads = 512;
constexpr unsigned long long kTimeoutNs = 120ull * 1000 * 1000 * 1000;

enum Dtype { kF32 = 0, kBF16 = 1 };

struct Peers {
  const void* data[kMaxRanks];  // rank p's symmetric buffer, mapped here
  unsigned long long* flags[kMaxRanks];  // rank p's flags, mapped here
};

// Flag (phase, block, source rank) in a rank's flag array.
__device__ __forceinline__ int flag_index(int phase, int block, int src) {
  return (phase * kMaxBlocks + block) * kMaxRanks + src;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every rank's block of this index reaches this point with epoch `e`.
__device__ void barrier(const Peers& peers, int phase, int m, int me, unsigned long long e) {
  __syncthreads();
  if (threadIdx.x < m) {
    const int p = threadIdx.x;
    __threadfence_system();
    store_release(peers.flags[p] + flag_index(phase, blockIdx.x, me), e);
    const unsigned long long* mine = peers.flags[me] + flag_index(phase, blockIdx.x, p);
    const unsigned long long t0 = now_ns();
    while (load_acquire(mine) < e) {
      if (now_ns() - t0 > kTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// 8 elements as f32, from a 16-byte-aligned address (two float4 or one uint4).
template <int T>
__device__ __forceinline__ void load8(const void* base, long long i, float v[8], bool l2_only) {
  if (T == kF32) {
    const float4* p = reinterpret_cast<const float4*>(base) + 2 * i;
    float4 a = l2_only ? __ldcg(p) : p[0];
    float4 b = l2_only ? __ldcg(p + 1) : p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(base) + i;
    uint4 a = l2_only ? __ldcg(p) : p[0];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
}

template <int T>
__device__ __forceinline__ void store8(void* base, long long i, const float v[8]) {
  if (T == kF32) {
    float4* p = reinterpret_cast<float4*>(base) + 2 * i;
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    reinterpret_cast<uint4*>(base)[i] = a;
  }
}

template <int T>
__device__ __forceinline__ void copy16(void* dst, const void* src, long long i) {
  // One 8-element vector of dtype T, bytes as they are.
  if (T == kF32) {
    reinterpret_cast<float4*>(dst)[2 * i] = reinterpret_cast<const float4*>(src)[2 * i];
    reinterpret_cast<float4*>(dst)[2 * i + 1] = reinterpret_cast<const float4*>(src)[2 * i + 1];
  } else {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
}

// x: this rank's partial [n] (n % 8 == 0); bias: [d] (d % 8 == 0) of the
// output dtype, broadcast along the rows of length d; out: [n].
// Vectors [lo, hi) of the n / 8 are this block's slice.
template <int TIn, int TOut>
__global__ void __launch_bounds__(kThreads) peer_allreduce_kernel(const void* __restrict__ x,
                                                                 const void* __restrict__ bias,
                                                                 void* __restrict__ out, long long n, long long d,
                                                                 Peers peers, int m, int me,
                                                                 unsigned long long* __restrict__ epochs) {
  __shared__ unsigned long long epoch;
  if (threadIdx.x == 0) {
    epoch = epochs[blockIdx.x] + 1;
    epochs[blockIdx.x] = epoch;
  }
  __syncthreads();
  const unsigned long long e = epoch;
  const long long vecs = n / 8;
  const long long per = (vecs + gridDim.x - 1) / gridDim.x;
  const long long lo = per * blockIdx.x;
  const long long hi = lo + per < vecs ? lo + per : vecs;
  if (m > 1) {
    void* mine = const_cast<void*>(peers.data[me]);
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) copy16<TIn>(mine, x, i);
    barrier(peers, 0, m, me, e);
  }
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    float acc[8], v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    for (int p = 0; p < m; ++p) {  // rank order: the same sum on every rank
      if (p == me) {
        load8<TIn>(x, i, v, false);
      } else {
        load8<TIn>(peers.data[p], i, v, true);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += v[k];
    }
    load8<TOut>(bias, (i * 8 % d) / 8, v, false);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += v[k];
    store8<TOut>(out, i, acc);
  }
  if (m > 1) barrier(peers, 1, m, me, e);
}

// Vectors [lo, hi) of the n / 8 that block b owns in rank r's slice, in the
// two-shot form (ops/peer_allreduce.py two_shot_ranges is the same cut).
__device__ __forceinline__ void two_shot_range(long long vecs, int m, int r, int blocks, int b, long long& lo,
                                               long long& hi) {
  const long long per_rank = (vecs + m - 1) / m;
  const long long per_block = (per_rank + blocks - 1) / blocks;
  const long long r_hi = per_rank * (r + 1) < vecs ? per_rank * (r + 1) : vecs;
  lo = per_rank * r + per_block * b;
  lo = lo < r_hi ? lo : r_hi;
  hi = lo + per_block < r_hi ? lo + per_block : r_hi;
}

// Vectors [lo, hi) of dtype T from src to dst, bytes as they are, four
// vectors in flight a thread; through L2 only when src is a peer's.
template <int T>
__device__ __forceinline__ void copy_vectors(void* dst, const void* src, long long lo, long long hi, bool l2_only) {
  constexpr int kWords = T == kF32 ? 2 : 1;  // uint4 words a vector
  const uint4* from = reinterpret_cast<const uint4*>(src);
  uint4* to = reinterpret_cast<uint4*>(dst);
  for (long long i = lo + threadIdx.x; i < hi; i += 4 * kThreads) {
    uint4 w[4][kWords];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + u * kThreads;
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        if (j < hi) w[u][k] = l2_only ? __ldcg(from + kWords * j + k) : from[kWords * j + k];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + u * kThreads;
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        if (j < hi) to[kWords * j + k] = w[u][k];
    }
  }
}

// The two-shot form: x this rank's f32 partial [n], out [n] of TOut, bias
// [d] of TOut; region B of each buffer starts n * 4 bytes in.
template <int TOut>
__global__ void __launch_bounds__(kThreads) peer_allreduce_two_shot_kernel(const float* __restrict__ x,
                                                                          const void* __restrict__ bias,
                                                                          void* __restrict__ out, long long n,
                                                                          long long d, Peers peers, int m, int me,
                                                                          unsigned long long* __restrict__ epochs) {
  __shared__ unsigned long long epoch;
  if (threadIdx.x == 0) {
    epoch = epochs[blockIdx.x] + 1;
    epochs[blockIdx.x] = epoch;
  }
  __syncthreads();
  const unsigned long long e = epoch;
  const long long vecs = n / 8;
  const long long region_b = n * static_cast<long long>(sizeof(float));
  void* mine = const_cast<void*>(peers.data[me]);
  long long lo, hi;
  for (int r = 0; r < m; ++r) {
    if (r == me) continue;
    two_shot_range(vecs, m, r, gridDim.x, blockIdx.x, lo, hi);
    copy_vectors<kF32>(mine, x, lo, hi, false);
  }
  barrier(peers, 0, m, me, e);
  two_shot_range(vecs, m, me, gridDim.x, blockIdx.x, lo, hi);
  void* reduced = static_cast<char*>(mine) + region_b;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    float v[kMaxRanks][8];
#pragma unroll
    for (int p = 0; p < kMaxRanks; ++p)
      if (p < m) load8<kF32>(p == me ? static_cast<const void*>(x) : peers.data[p], i, v[p], p != me);
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int p = 0; p < kMaxRanks; ++p) {  // rank order: the same sum on every rank
      if (p < m) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] += v[p][k];
      }
    }
    float b[8];
    load8<TOut>(bias, (i * 8 % d) / 8, b, false);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += b[k];
    store8<TOut>(out, i, acc);
    store8<TOut>(reduced, i, acc);
  }
  barrier(peers, 1, m, me, e);
  for (int r = 0; r < m; ++r) {
    if (r == me) continue;
    two_shot_range(vecs, m, r, gridDim.x, blockIdx.x, lo, hi);
    copy_vectors<TOut>(out, static_cast<const char*>(peers.data[r]) + region_b, lo, hi, true);
  }
  barrier(peers, 2, m, me, e);
}

template <int TIn, int TOut>
cudaError_t launch(const void* x, const void* bias, void* out, long long n, long long d, const Peers& peers, int m,
                   int me, unsigned long long* epochs, int blocks, cudaStream_t stream) {
  peer_allreduce_kernel<TIn, TOut><<<blocks, kThreads, 0, stream>>>(x, bias, out, n, d, peers, m, me, epochs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int vpt_par_max_ranks() { return kMaxRanks; }
int vpt_par_max_blocks() { return kMaxBlocks; }
int vpt_par_threads() { return kThreads; }
// Bytes of a rank's flag array: 3 phases x kMaxBlocks x kMaxRanks epochs.
long long vpt_par_flag_bytes() { return 3LL * kMaxBlocks * kMaxRanks * sizeof(unsigned long long); }

// cudaMalloc on `device`, zeroed (and the zeros complete) before it returns.
int vpt_par_malloc(int device, long long bytes, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemset(*ptr, 0, bytes);
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}

int vpt_par_free(void* ptr) { return cudaFree(ptr); }

// The IPC handle of an allocation, as 64 bytes (CUDA_IPC_HANDLE_SIZE).
int vpt_par_ipc_handle(void* ptr, char* out) {
  cudaIpcMemHandle_t h;
  cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err != cudaSuccess) return err;
  memcpy(out, &h, sizeof(h));
  return 0;
}

// Maps a peer's allocation (its 64-byte handle) into this process on `device`.
int vpt_par_ipc_open(int device, const char* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int vpt_par_ipc_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

// The PCI bus id of `device` ("0000:18:00.0"), into out[len].
int vpt_par_bus_id(int device, char* out, int len) { return cudaDeviceGetPCIBusId(out, len, device); }

// Whether `device` can map the memory of the card at PCI bus id `peer`:
// *ok = 1 (the same card, or peer access), 0 (no peer access), -1 (that card
// is not visible to this process).
int vpt_par_peer_access(int device, const char* peer, int* ok) {
  int other = -1;
  if (cudaDeviceGetByPCIBusId(&other, peer) != cudaSuccess) {
    cudaGetLastError();  // clear the lookup's error
    *ok = -1;
    return 0;
  }
  if (other == device) {
    *ok = 1;
    return 0;
  }
  return cudaDeviceCanAccessPeer(ok, device, other);
}

// The all-reduce: x [n] of dtype x_dtype (0 f32, 1 bf16) on this rank; out
// [n] of out_dtype; bias [d] of out_dtype; data[m], flags[m] the
// group's buffers as this process maps them (this rank's own at index me),
// each data buffer `capacity` bytes; epochs: this rank's kMaxBlocks
// counters. form: 0 one-shot, 1 two-shot (f32 partials, m > 1). n and d
// multiples of 8, every pointer 16-byte aligned, m <= kMaxRanks, 1 <= blocks
// <= kMaxBlocks. Returns a cudaError_t value, or -1 for arguments out of
// range (a buffer too small for the form included).
int vpt_par_allreduce(const void* x, int x_dtype, const void* bias, void* out, int out_dtype, long long n,
                      long long d, const void* const* data, void* const* flags, int m, int me, void* epochs,
                      int blocks, int form, long long capacity, void* stream) {
  if (m < 1 || m > kMaxRanks || me < 0 || me >= m || blocks < 1 || blocks > kMaxBlocks || n % 8 || d < 8 ||
      d % 8 || (form != 0 && form != 1))
    return -1;
  const long long in_bytes = n * (x_dtype == kF32 ? 4 : 2), out_bytes = n * (out_dtype == kF32 ? 4 : 2);
  if (form == 1 && (m < 2 || x_dtype != kF32 || capacity < in_bytes + out_bytes)) return -1;
  if (form == 0 && m > 1 && capacity < in_bytes) return -1;
  Peers peers = {};
  for (int p = 0; p < m; ++p) {
    peers.data[p] = data[p];
    peers.flags[p] = static_cast<unsigned long long*>(flags[p]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* ep = static_cast<unsigned long long*>(epochs);
  if (form == 1) {
    const float* xf = static_cast<const float*>(x);
    if (out_dtype == kF32) {
      peer_allreduce_two_shot_kernel<kF32><<<blocks, kThreads, 0, s>>>(xf, bias, out, n, d, peers, m, me, ep);
    } else if (out_dtype == kBF16) {
      peer_allreduce_two_shot_kernel<kBF16><<<blocks, kThreads, 0, s>>>(xf, bias, out, n, d, peers, m, me, ep);
    } else {
      return -1;
    }
    return cudaGetLastError();
  }
  if (x_dtype == kF32 && out_dtype == kF32) return launch<kF32, kF32>(x, bias, out, n, d, peers, m, me, ep, blocks, s);
  if (x_dtype == kF32 && out_dtype == kBF16) return launch<kF32, kBF16>(x, bias, out, n, d, peers, m, me, ep, blocks, s);
  if (x_dtype == kBF16 && out_dtype == kBF16)
    return launch<kBF16, kBF16>(x, bias, out, n, d, peers, m, me, ep, blocks, s);
  return -1;
}

}  // extern "C"
