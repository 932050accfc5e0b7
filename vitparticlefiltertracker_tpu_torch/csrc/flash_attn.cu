// Non-causal attention forward, softmax(Q K^T / sqrt(d)) V, for Hopper (sm_90a).
//
// Replaces: _flash_kernel in vitparticlefiltertracker_tpu/ops/attention.py
// (launched by flash_attention there). Same function and rounding: products
// take the input type and accumulate in f32; the 1/sqrt(d) scale multiplies
// the f32 logits; the max, the sum and the accumulator are f32; for bf16 the
// probabilities are rounded to bf16 before the P.V product, as the TPU kernel
// casts them to V's type; keys at index >= T are masked; query rows past T
// are never written.
//
// Operands are strided views: q, k, v and o each come as a base pointer plus
// element strides for (b, h, t); the head dim (64) has stride 1 and every row
// starts on 16 bytes. So the kernel reads q, k and v straight out of the ViT's
// fused qkv activation [B, T, H, 3, 64] (one token's q row is 128 contiguous
// bytes, the token stride 3*H*64) and writes o straight into [B, T, H, 64]
// memory: no copy before or after it. Work items (a (b, h) pair, or a query
// tile of one) sit on grid.x and are looped over, so B*H has no 65,535 cap.
//
// What bounds it on this card, and what the design does about it. At both of
// the tracker's shapes the floor is bytes: [1024, 12, 4, 64] bf16 (crop mode)
// moves 25 MB for 5e7 FLOP, 7.5 us at 3.35 TB/s; [1, 12, 196, 64] bf16
// (dense mode) moves 1.2 MB for 1.2e8 FLOP, 0.36 us, where in practice launch
// latency and the few heads in flight decide. Three paths, chosen by the
// wrapper's launch plan (ops/attention.py, launch_plan):
//
//  * small (T <= kSmallTMax, both dtypes): one warp per (b, h) pair, several
//    pairs a block. The warp loads its T rows of q, k and v with 16-byte
//    loads into f32 shared memory, computes the T x T logits and a full
//    softmax (no tiling, no online rescale), and writes T output rows with
//    16-byte stores. At T = 4 that is 2*4*4*64 FMA a head: scalar f32 is
//    plenty, and the time is the bytes in and out.
//  * tiled bf16 (T > kSmallTMax): tensor cores. Each warp owns 16 query rows;
//    S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, f32
//    accumulate), with operands from shared memory by ldmatrix (.trans for
//    V). The online softmax runs on the accumulator fragments (row max and
//    sum over the 4 lanes of a quad by shuffles), and P is packed to bf16 in
//    registers and reused as the A operand of P V. 64-key K and V tiles come
//    in by cp.async, double-buffered; rows are padded to 72 elements so
//    ldmatrix's 8 rows fall in distinct banks. The plan picks 1, 2 or 4 warps
//    a block so that [1, 12, 196, 64] puts 156 blocks on the 132 SMs.
//  * tiled and split f32 (T > kSmallTMax): 3xTF32 on tensor cores, in the
//    bf16 path's structure (16 query rows a warp, 4 warps a block, the
//    online softmax on the accumulator fragments, double-buffered cp.async
//    K and V tiles of 64 keys; the split path puts a block's 4 warps on one
//    16-row tile, below). Every f32 operand x is split in registers
//    into big = tf32(x) and small = tf32(x - big), and each product runs as
//    three mma.sync m16n8k8 (tf32 in, f32 accumulate): small*big, big*small,
//    then big*big; small*small (2^-22 of the product) is dropped. That keeps
//    the TPU kernel's Precision.HIGHEST: f32 products to about f32
//    precision, f32 softmax statistics (expf), P split in registers, never
//    rounded; each tile's P.V starts from zero and joins the accumulator by
//    acc * alpha + PV in f32, as the TPU kernel's acc_ref update. Rows are
//    padded to 68 floats (272 B), so the 32-bit fragment loads (ldmatrix is
//    b16 only) fall in 32 distinct banks: rows g, columns tq for Q and K,
//    rows 2tq and 2tq+1, columns g for V. Chosen over a register-tiled
//    FFMA kernel because the FLOP decide at the scan's shape ([49, 12, 196,
//    64]: 5.8 GFLOP, 86 us at FFMA's 67 TFLOP/s; 35 us at 3xTF32's 495/3)
//    and because it reuses the bf16 path's staging and softmax. (The first
//    version here was scalar FMAs over 64 query rows a block: 48 blocks at
//    eval1's [1, 12, 196, 64], 6x slower than the plain version; the split
//    path gives that shape's 156 tiles 4 warps each.)
// wgmma and TMA are left out: their 64-row warpgroup tile and descriptors do
// not pay at four 64-row tiles a head (T = 196) or 4 live rows (T = 4).
//
// Interface: plain C, loaded with ctypes. Returns cudaGetLastError() after
// the launch (0 = success), -1 for arguments the kernel does not take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sm90.cuh"  // cp.async, ldmatrix, mma.sync m16n8k16 (bf16, f32 accumulate); tf32 below

namespace {

constexpr int kD = 64;           // head dim (every ViT preset of the repo)
constexpr int kSmallTMax = 16;   // small path up to this T (crop sizes 32/48/64)
constexpr int kSmallMaxWarps = 8;
constexpr int kTileK = 64;       // keys per shared-memory tile (tiled paths)
constexpr int kRowStride = kD + 8;  // bf16 row pitch in shared memory: 144 B
constexpr int kMmaMaxWarps = 4;     // tiled paths: warps of 16 query rows a block (bf16 also 1 or 2)
constexpr int kF32RowStride = kD + 4;  // f32 row pitch in shared memory: 272 B

typedef __nv_bfloat16 bf16;

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // element strides of (b, h, t)
  int b, h, t;
  float scale;
};

// Element offset of (b, h) pair `pair` (= b * heads + h), given the b and h strides.
__device__ __forceinline__ long long pair_offset(long long sb, long long sh, long long pair, int heads) {
  return (pair / heads) * sb + (pair % heads) * sh;
}

// Probability as the P.V product sees it: rounded to the input type.
template <typename T> __device__ __forceinline__ float as_input_type(float p);
template <> __device__ __forceinline__ float as_input_type<float>(float p) { return p; }
template <> __device__ __forceinline__ float as_input_type<bf16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// One 16-byte load -> f32 values (4 for f32, 8 for bf16).
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void load16(const bf16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Eight f32 values -> the output type, 16-byte stores.
__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(bf16* dst, const float* x) {
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// ---------------------------------------------------------------------------
// Small path: one warp per (b, h) pair.
// ---------------------------------------------------------------------------

// f32 words of shared memory one warp uses at this T: v [T][64], q and k
// [T][65] (padded: lanes on different rows read different banks), p [T][T+1]
// (the last column holds 1/sum). Rounded to 4 words so every warp's v region
// is 16-byte aligned.
__host__ __device__ __forceinline__ int small_words_per_warp(int t) {
  return (t * kD + 2 * t * (kD + 1) + t * (t + 1) + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(kSmallMaxWarps * 32)
attn_small_kernel(const Problem prob) {
  extern __shared__ __align__(16) unsigned char vpt_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int t = prob.t;
  float* vs = reinterpret_cast<float*>(vpt_smem) + warp * small_words_per_warp(t);
  float* qs = vs + t * kD;
  float* ks = qs + t * (kD + 1);
  float* ps = ks + t * (kD + 1);
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = kD / kVec;    // 16-byte chunks per row

  const long long pairs = static_cast<long long>(prob.b) * prob.h;
  for (long long pair = static_cast<long long>(blockIdx.x) * warps + warp; pair < pairs;
       pair += static_cast<long long>(gridDim.x) * warps) {
    const T* q = static_cast<const T*>(prob.q) + pair_offset(prob.sq[0], prob.sq[1], pair, prob.h);
    const T* k = static_cast<const T*>(prob.k) + pair_offset(prob.sk[0], prob.sk[1], pair, prob.h);
    const T* v = static_cast<const T*>(prob.v) + pair_offset(prob.sv[0], prob.sv[1], pair, prob.h);
    T* o = static_cast<T*>(prob.o) + pair_offset(prob.so[0], prob.so[1], pair, prob.h);

    for (int c = lane; c < t * kChunks; c += 32) {
      const int r = c / kChunks, col = (c % kChunks) * kVec;
      float x[kVec];
      load16(q + r * prob.sq[2] + col, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qs[r * (kD + 1) + col + e] = x[e];
      load16(k + r * prob.sk[2] + col, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) ks[r * (kD + 1) + col + e] = x[e];
      load16(v + r * prob.sv[2] + col, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) vs[r * kD + col + e] = x[e];
    }
    __syncwarp();

    for (int idx = lane; idx < t * t; idx += 32) {
      const int i = idx / t, j = idx % t;
      const float* qr = qs + i * (kD + 1);
      const float* kr = ks + j * (kD + 1);
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < kD; ++c) s = fmaf(qr[c], kr[c], s);
      ps[i * (t + 1) + j] = s * prob.scale;
    }
    __syncwarp();

    if (lane < t) {  // t <= kSmallTMax < 32: one lane per row
      float* row = ps + lane * (t + 1);
      float m = -CUDART_INF_F;
      for (int j = 0; j < t; ++j) m = fmaxf(m, row[j]);
      float l = 0.f;
      for (int j = 0; j < t; ++j) {
        const float p = expf(row[j] - m);
        l += p;
        row[j] = as_input_type<T>(p);
      }
      row[t] = 1.f / l;
    }
    __syncwarp();

    // Lane -> 8 output columns of every fourth row.
    const int c0 = (lane & 7) * 8;
    for (int i = lane >> 3; i < t; i += 4) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      const float* prow = ps + i * (t + 1);
      for (int j = 0; j < t; ++j) {
        const float pj = prow[j];
        const float4 a = *reinterpret_cast<const float4*>(vs + j * kD + c0);
        const float4 b = *reinterpret_cast<const float4*>(vs + j * kD + c0 + 4);
        acc[0] = fmaf(pj, a.x, acc[0]); acc[1] = fmaf(pj, a.y, acc[1]);
        acc[2] = fmaf(pj, a.z, acc[2]); acc[3] = fmaf(pj, a.w, acc[3]);
        acc[4] = fmaf(pj, b.x, acc[4]); acc[5] = fmaf(pj, b.y, acc[5]);
        acc[6] = fmaf(pj, b.z, acc[6]); acc[7] = fmaf(pj, b.w, acc[7]);
      }
      const float inv = prow[t];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= inv;
      store8(o + i * prob.so[2] + c0, acc);
    }
    __syncwarp();  // the next pair overwrites this warp's shared memory
  }
}

// ---------------------------------------------------------------------------
// Tiled bf16 path: mma.sync on tensor cores.
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int mma_smem_bytes(int warps) {
  return static_cast<int>(sizeof(bf16)) * (4 * kTileK + 16 * warps) * kRowStride;
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + tq.
// A (16x16, row): a0 = A[g][2tq..], a1 = A[g+8][2tq..], a2 = A[g][2tq+8..],
// a3 = A[g+8][2tq+8..]. B (16x8, col): b0 = B[2tq..][g], b1 = B[2tq+8..][g].
// C (16x8): c0, c1 = C[g][2tq..], c2, c3 = C[g+8][2tq..].
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
attn_tiled_bf16_kernel(const Problem prob) {
  extern __shared__ __align__(16) unsigned char vpt_smem[];
  bf16* ks = reinterpret_cast<bf16*>(vpt_smem);  // [2][kTileK][kRowStride]
  bf16* vs = ks + 2 * kTileK * kRowStride;       // [2][kTileK][kRowStride]
  bf16* qs = vs + 2 * kTileK * kRowStride;       // [warps * 16][kRowStride]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;  // ldmatrix: which 8x8 matrix, which of its rows
  const int t = prob.t;
  const int rows_per_block = (nthreads >> 5) * 16;
  const int q_tiles = (t + rows_per_block - 1) / rows_per_block;
  const int k_tiles = (t + kTileK - 1) / kTileK;
  const long long items = static_cast<long long>(prob.b) * prob.h * q_tiles;
  bf16* my_q = qs + warp * 16 * kRowStride;
  const long long sqt = prob.sq[2], skt = prob.sk[2], svt = prob.sv[2], sot = prob.so[2];

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long pair = item / q_tiles;
    const int q0 = static_cast<int>(item % q_tiles) * rows_per_block;
    const bf16* qg = static_cast<const bf16*>(prob.q) + pair_offset(prob.sq[0], prob.sq[1], pair, prob.h);
    const bf16* kg = static_cast<const bf16*>(prob.k) + pair_offset(prob.sk[0], prob.sk[1], pair, prob.h);
    const bf16* vg = static_cast<const bf16*>(prob.v) + pair_offset(prob.sv[0], prob.sv[1], pair, prob.h);
    bf16* og = static_cast<bf16*>(prob.o) + pair_offset(prob.so[0], prob.so[1], pair, prob.h);

    auto load_kv = [&](int tile) {
      const int k0 = tile * kTileK;
      bf16* kd = ks + (tile & 1) * kTileK * kRowStride;
      bf16* vd = vs + (tile & 1) * kTileK * kRowStride;
      for (int c = tid; c < kTileK * (kD / 8); c += nthreads) {
        const int r = c >> 3, col = (c & 7) * 8;
        const bool ok = k0 + r < t;
        const long long key = ok ? k0 + r : 0;
        cp_async16(kd + r * kRowStride + col, kg + key * skt + col, ok);
        cp_async16(vd + r * kRowStride + col, vg + key * svt + col, ok);
      }
    };

    for (int c = tid; c < rows_per_block * (kD / 8); c += nthreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      const bool ok = q0 + r < t;
      cp_async16(qs + r * kRowStride + col, qg + (ok ? static_cast<long long>(q0 + r) * sqt : 0) + col, ok);
    }
    load_kv(0);
    cp_async_commit();

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of rows g, g+8
    float l[2] = {0.f, 0.f};                      // this lane's part of the running sum
    float acc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
    uint32_t qf[4][4];

    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles) {
        load_kv(kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(qf[kk], my_q + (mr + (mat & 1) * 8) * kRowStride + kk * 16 + (mat >> 1) * 8);
      }
      const bf16* kb = ks + (kt & 1) * kTileK * kRowStride;
      const bf16* vb = vs + (kt & 1) * kTileK * kRowStride;

      float s[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nb = 0; nb < 8; nb += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kb + (nb * 8 + mr + (mat >> 1) * 8) * kRowStride + kk * 16 + (mat & 1) * 8);
          mma_bf16(s[nb], qf[kk], b[0], b[1]);
          mma_bf16(s[nb + 1], qf[kk], b[2], b[3]);
        }
      }

      // Scale, mask keys >= T, and the online softmax on the fragments.
      const int k0 = kt * kTileK;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nb * 8 + 2 * tq + (e & 1);
          const float x = key < t ? s[nb][e] * prob.scale : -CUDART_INF_F;
          s[nb][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // Key k0 is always valid, so the new max is finite; exp(-inf) = 0
        // on the first tile.
        alpha[r] = __expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
      uint32_t pf[4][4];  // P in bf16 as the A operand: 4 slices of 16 keys
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float p0 = __expf(s[nb][0] - m[0]);
        const float p1 = __expf(s[nb][1] - m[0]);
        const float p2 = __expf(s[nb][2] - m[1]);
        const float p3 = __expf(s[nb][3] - m[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[nb >> 1][(nb & 1) * 2] = pack_bf16(p0, p1);
        pf[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        acc[nb][0] *= alpha[0];
        acc[nb][1] *= alpha[0];
        acc[nb][2] *= alpha[1];
        acc[nb][3] *= alpha[1];
      }
#pragma unroll
      for (int ksl = 0; ksl < 4; ++ksl) {
#pragma unroll
        for (int nb = 0; nb < 8; nb += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vb + (ksl * 16 + mr + (mat & 1) * 8) * kRowStride + nb * 8 + (mat >> 1) * 8);
          mma_bf16(acc[nb], pf[ksl], b[0], b[1]);
          mma_bf16(acc[nb + 1], pf[ksl], b[2], b[3]);
        }
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    // 1/sum over the quad, then the tile goes out through this warp's own Q
    // rows in shared memory, so the stores are 16 bytes a lane.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      *reinterpret_cast<__nv_bfloat162*>(my_q + g * kRowStride + nb * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[nb][0] * inv[0], acc[nb][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(my_q + (g + 8) * kRowStride + nb * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[nb][2] * inv[1], acc[nb][3] * inv[1]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * (kD / 8); c += 32) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int row = q0 + warp * 16 + r;
      if (row < t)
        *reinterpret_cast<uint4*>(og + static_cast<long long>(row) * sot + col) =
            *reinterpret_cast<const uint4*>(my_q + r * kRowStride + col);
    }
    __syncthreads();  // the next item restages Q and K/V
  }
}

// ---------------------------------------------------------------------------
// Tiled f32 path: 3xTF32 on tensor cores.
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 4;         // the split path: 4 warps share one 16-row tile
constexpr int kPStride = kD + 8;       // f32 pitch of the split path's P tile: 288 B

// Dynamic shared memory of the f32 paths: K and V double-buffered, the
// query rows, and (split path) the P tile and the row maxima exchanged.
__host__ __device__ __forceinline__ int tf32_smem_bytes(int warps, bool split) {
  const int rows = split ? 16 : 16 * warps;
  const int words = (4 * kTileK + rows) * kF32RowStride + (split ? 16 * kPStride + 16 * warps : 0);
  return static_cast<int>(sizeof(float)) * words;
}

// x = big + small + O(2^-21 |x|): big is x rounded to TF32 (to nearest,
// ties away, on the bits), small = x - big exactly in f32, which the tensor
// core reads as TF32 by dropping its low 13 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c[16x8] += a[16x8] b[8x8]; tf32 in, f32 accumulate. Not volatile: the
// compiler may interleave the products of different accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a b[j] over NB column blocks in about f32 precision: the two
// cross terms first, then big x big, each pass over all NB accumulators so
// that consecutive products never wait on each other. b: [j][0 big, 1
// small][b0, b1].
template <int NB>
__device__ __forceinline__ void mma_3xtf32(float (&c)[NB][4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const uint32_t (&b)[NB][2][2]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_tf32(c[j], a_small, b[j][0][0], b[j][0][1]);
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_tf32(c[j], a_big, b[j][1][0], b[j][1][1]);
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_tf32(c[j], a_big, b[j][0][0], b[j][0][1]);
}

// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 g + tq.
// A (16x8, row): a0 = A[g][tq], a1 = A[g+8][tq], a2 = A[g][tq+4],
// a3 = A[g+8][tq+4]. B (8x8, col): b0 = B[tq][g], b1 = B[tq+4][g].
// C (16x8): c0, c1 = C[g][2tq..], c2, c3 = C[g+8][2tq..].
// In P.V the sum over an 8-key slice runs in the order the S fragment holds
// it: logical k = tq is key 2tq and k = tq+4 is key 2tq+1, so P's A operand
// is S's (c0, c2, c1, c3) with no shuffle, and V's B rows are 2tq, 2tq+1.
//
// NS = 1 (path "tiled"): each warp owns 16 query rows outright, the 4
// warps of a block share the K/V tiles. NS = kSplitWarps (path "split"): the
// block's 4 warps share one 16-row tile; warp `part` computes S for 16 of
// each tile's 64 keys and P.V for 16 of the 64 output dims, and the tile's
// row maxima and P go through shared memory (three barriers a tile). Each
// warp then runs a quarter of the products, so a call with few query
// tiles (eval1's [1, 12, 196, 64]: 156) keeps 4 times as many warps busy.
template <int NS>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
attn_tiled_f32_kernel(const Problem prob) {
  constexpr int NB = 8 / NS;  // 8-key blocks of S and 8-dim blocks of O this warp computes
  extern __shared__ __align__(16) unsigned char vpt_smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int part = warp % NS;
  const int rows_per_block = (nthreads >> 5) / NS * 16;
  float* ks = reinterpret_cast<float*>(vpt_smem);  // [2][kTileK][kF32RowStride]
  float* vs = ks + 2 * kTileK * kF32RowStride;     // [2][kTileK][kF32RowStride]
  float* qs = vs + 2 * kTileK * kF32RowStride;     // [rows_per_block][kF32RowStride]
  float* ps = qs + rows_per_block * kF32RowStride;  // NS > 1: P [16][kPStride]
  float* red = ps + 16 * kPStride;                  // NS > 1: row maxima [NS][16]
  const int t = prob.t;
  const int q_tiles = (t + rows_per_block - 1) / rows_per_block;
  const int k_tiles = (t + kTileK - 1) / kTileK;
  const long long items = static_cast<long long>(prob.b) * prob.h * q_tiles;
  float* my_q = qs + (warp / NS) * 16 * kF32RowStride;
  const long long sqt = prob.sq[2], skt = prob.sk[2], svt = prob.sv[2], sot = prob.so[2];
  constexpr int kChunks = kD / 4;  // 16-byte chunks of an f32 row

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long pair = item / q_tiles;
    const int q0 = static_cast<int>(item % q_tiles) * rows_per_block;
    const float* qg = static_cast<const float*>(prob.q) + pair_offset(prob.sq[0], prob.sq[1], pair, prob.h);
    const float* kg = static_cast<const float*>(prob.k) + pair_offset(prob.sk[0], prob.sk[1], pair, prob.h);
    const float* vg = static_cast<const float*>(prob.v) + pair_offset(prob.sv[0], prob.sv[1], pair, prob.h);
    float* og = static_cast<float*>(prob.o) + pair_offset(prob.so[0], prob.so[1], pair, prob.h);

    auto load_kv = [&](int tile) {
      const int k0 = tile * kTileK;
      float* kd = ks + (tile & 1) * kTileK * kF32RowStride;
      float* vd = vs + (tile & 1) * kTileK * kF32RowStride;
      for (int c = tid; c < kTileK * kChunks; c += nthreads) {
        const int r = c / kChunks, col = (c % kChunks) * 4;
        const bool ok = k0 + r < t;
        const long long key = ok ? k0 + r : 0;
        cp_async16(kd + r * kF32RowStride + col, kg + key * skt + col, ok);
        cp_async16(vd + r * kF32RowStride + col, vg + key * svt + col, ok);
      }
    };

    for (int c = tid; c < rows_per_block * kChunks; c += nthreads) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
      const bool ok = q0 + r < t;
      cp_async16(qs + r * kF32RowStride + col, qg + (ok ? static_cast<long long>(q0 + r) * sqt : 0) + col, ok);
    }
    load_kv(0);
    cp_async_commit();

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of rows g, g+8
    float l[2] = {0.f, 0.f};                      // this lane's part of the running sum
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      if (kt + 1 < k_tiles) {
        load_kv(kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* kb = ks + (kt & 1) * kTileK * kF32RowStride;
      const float* vb = vs + (kt & 1) * kTileK * kF32RowStride;

      // S = Q K^T for this warp's keys, over the 64 dims in 8 slices; Q's
      // fragments are split from shared memory again each tile.
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t qb[4], qsm[4];
        const float* q_row = my_q + g * kF32RowStride + kk * 8 + tq;
        split_tf32(q_row[0], qb[0], qsm[0]);
        split_tf32(q_row[8 * kF32RowStride], qb[1], qsm[1]);
        split_tf32(q_row[4], qb[2], qsm[2]);
        split_tf32(q_row[8 * kF32RowStride + 4], qb[3], qsm[3]);
        uint32_t kf[NB][2][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float* k_row = kb + ((part * NB + j) * 8 + g) * kF32RowStride + kk * 8 + tq;
          split_tf32(k_row[0], kf[j][0][0], kf[j][1][0]);
          split_tf32(k_row[4], kf[j][0][1], kf[j][1][1]);
        }
        mma_3xtf32<NB>(s, qb, qsm, kf);
      }

      // Scale, mask keys >= T, and the online softmax on the fragments.
      const int k0 = kt * kTileK;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + (part * NB + j) * 8 + 2 * tq + (e & 1);
          const float x = key < t ? s[j][e] * prob.scale : -CUDART_INF_F;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      if (NS > 1) {  // the tile's row maxima over the 4 warps' keys
        if (tq == 0) {
          red[part * 16 + g] = mx[0];
          red[part * 16 + g + 8] = mx[1];
        }
        __syncthreads();
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          mx[0] = fmaxf(mx[0], red[p * 16 + g]);
          mx[1] = fmaxf(mx[1], red[p * 16 + g + 8]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // Key k0 is always valid, so the new max is finite; exp(-inf) = 0
        // on the first tile.
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        s[j][0] = expf(s[j][0] - m[0]);
        s[j][1] = expf(s[j][1] - m[0]);
        s[j][2] = expf(s[j][2] - m[1]);
        s[j][3] = expf(s[j][3] - m[1]);
      }
      // P as the A operand, 8 keys a slice: from this warp's own S (NS = 1),
      // or from the whole tile's P in shared memory (NS > 1).
      float pa[8][4];
      if (NS == 1) {
#pragma unroll
        for (int ksl = 0; ksl < 8; ++ksl) {
          pa[ksl][0] = s[ksl % NB][0];
          pa[ksl][1] = s[ksl % NB][2];
          pa[ksl][2] = s[ksl % NB][1];
          pa[ksl][3] = s[ksl % NB][3];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int col = (part * NB + j) * 8 + 2 * tq;
          *reinterpret_cast<float2*>(ps + g * kPStride + col) = make_float2(s[j][0], s[j][1]);
          *reinterpret_cast<float2*>(ps + (g + 8) * kPStride + col) = make_float2(s[j][2], s[j][3]);
        }
        __syncthreads();
#pragma unroll
        for (int ksl = 0; ksl < 8; ++ksl) {
          const float2 r0 = *reinterpret_cast<const float2*>(ps + g * kPStride + ksl * 8 + 2 * tq);
          const float2 r1 = *reinterpret_cast<const float2*>(ps + (g + 8) * kPStride + ksl * 8 + 2 * tq);
          pa[ksl][0] = r0.x;
          pa[ksl][1] = r1.x;
          pa[ksl][2] = r0.y;
          pa[ksl][3] = r1.y;
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int ksl = 0; ksl < 8; ++ksl) {
        rs[0] += pa[ksl][0] + pa[ksl][2];
        rs[1] += pa[ksl][1] + pa[ksl][3];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];

      // This tile's P V (this warp's dims) from zero, then acc = acc * alpha
      // + P V in f32, as the TPU kernel's acc_ref update.
      float pv[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
      for (int ksl = 0; ksl < 8; ++ksl) {
        uint32_t pb[4], psm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(pa[ksl][e], pb[e], psm[e]);
        const float* v_row = vb + (ksl * 8 + 2 * tq) * kF32RowStride + part * NB * 8 + g;
        uint32_t vf[NB][2][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          split_tf32(v_row[j * 8], vf[j][0][0], vf[j][1][0]);
          split_tf32(v_row[kF32RowStride + j * 8], vf[j][0][1], vf[j][1][1]);
        }
        mma_3xtf32<NB>(pv, pb, psm, vf);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc[j][0] = fmaf(acc[j][0], alpha[0], pv[j][0]);
        acc[j][1] = fmaf(acc[j][1], alpha[0], pv[j][1]);
        acc[j][2] = fmaf(acc[j][2], alpha[1], pv[j][2]);
        acc[j][3] = fmaf(acc[j][3], alpha[1], pv[j][3]);
      }
      __syncthreads();  // every warp is done with this buffer (and P, the maxima) before they are refilled
    }

    // 1/sum over the quad, then the block's rows go out through their Q rows
    // in shared memory, so the stores are 16 bytes a thread.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = (part * NB + j) * 8 + 2 * tq;
      *reinterpret_cast<float2*>(my_q + g * kF32RowStride + col) = make_float2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
      *reinterpret_cast<float2*>(my_q + (g + 8) * kF32RowStride + col) =
          make_float2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
    __syncthreads();
    for (int c = tid; c < rows_per_block * kChunks; c += nthreads) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
      if (q0 + r < t)
        *reinterpret_cast<float4*>(og + static_cast<long long>(q0 + r) * sot + col) =
            *reinterpret_cast<const float4*>(qs + r * kF32RowStride + col);
    }
    __syncthreads();  // the next item restages Q and K/V
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum Path { kSmall = 0, kTiled = 1, kSplit = 2 };
enum Dtype { kF32 = 0, kBF16 = 1 };

// Dynamic shared memory of one block, or -1 for a path/dtype/warps the
// kernels do not take.
int smem_bytes(int path, int dtype, int t, int warps) {
  if (path == kSmall) {
    if (t < 1 || t > kSmallTMax || warps < 1 || warps > kSmallMaxWarps) return -1;
    return static_cast<int>(sizeof(float)) * warps * small_words_per_warp(t);
  }
  if (path == kTiled && dtype == kBF16) {
    if (warps != 1 && warps != 2 && warps != 4) return -1;
    return mma_smem_bytes(warps);
  }
  if (path == kTiled && dtype == kF32) return warps == kMmaMaxWarps ? tf32_smem_bytes(warps, false) : -1;
  if (path == kSplit && dtype == kF32) return warps == kSplitWarps ? tf32_smem_bytes(warps, true) : -1;
  return -1;
}

template <typename F>
cudaError_t allow_smem(F* kernel, bool* done, int bytes) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, h, t) of q, k, v, o in that order.
// dtype: 0 = float32, 1 = bfloat16. path: 0 = small (T <= 16), 1 = tiled,
// 2 = split (float32, T > 16, 4 warps on one 16-row tile).
// warps: warps a block; grid: blocks (the kernels loop over their work
// items, so any grid >= 1 is correct). Returns a cudaError_t value
// (0 = success), -1 for arguments the kernels do not take.
int vpt_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                       const long long* strides, int b, int h, int t, int d, int dtype,
                       float scale, int path, int warps, int grid, void* stream) {
  if (d != kD || b <= 0 || h <= 0 || t <= 0 || grid <= 0 || (dtype != kF32 && dtype != kBF16)) return -1;
  const int smem = smem_bytes(path, dtype, t, warps);
  if (smem < 0) return -1;
  Problem prob;
  prob.q = q;
  prob.k = k;
  prob.v = v;
  prob.o = o;
  for (int i = 0; i < 3; ++i) {
    prob.sq[i] = strides[i];
    prob.sk[i] = strides[3 + i];
    prob.sv[i] = strides[6 + i];
    prob.so[i] = strides[9 + i];
  }
  prob.b = b;
  prob.h = h;
  prob.t = t;
  prob.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32 * warps);
  cudaError_t e = cudaSuccess;
  if (path == kSmall && dtype == kF32) {
    static bool done = false;
    e = allow_smem(attn_small_kernel<float>, &done, smem_bytes(kSmall, kF32, kSmallTMax, kSmallMaxWarps));
    if (e == cudaSuccess) attn_small_kernel<float><<<grid, block, smem, s>>>(prob);
  } else if (path == kSmall) {
    static bool done = false;
    e = allow_smem(attn_small_kernel<bf16>, &done, smem_bytes(kSmall, kBF16, kSmallTMax, kSmallMaxWarps));
    if (e == cudaSuccess) attn_small_kernel<bf16><<<grid, block, smem, s>>>(prob);
  } else if (dtype == kBF16) {
    static bool done = false;
    e = allow_smem(attn_tiled_bf16_kernel, &done, mma_smem_bytes(kMmaMaxWarps));
    if (e == cudaSuccess) attn_tiled_bf16_kernel<<<grid, block, smem, s>>>(prob);
  } else if (path == kTiled) {
    static bool done = false;
    e = allow_smem(attn_tiled_f32_kernel<1>, &done, tf32_smem_bytes(kMmaMaxWarps, false));
    if (e == cudaSuccess) attn_tiled_f32_kernel<1><<<grid, block, smem, s>>>(prob);
  } else {
    static bool done = false;
    e = allow_smem(attn_tiled_f32_kernel<kSplitWarps>, &done, tf32_smem_bytes(kSplitWarps, true));
    if (e == cudaSuccess) attn_tiled_f32_kernel<kSplitWarps><<<grid, block, smem, s>>>(prob);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory one block of that launch asks for (-1 if the
// kernels do not take it), so a caller can print it.
int vpt_flash_attn_smem_bytes(int path, int dtype, int t, int warps) {
  return smem_bytes(path, dtype, t, warps);
}

}  // extern "C"
