// Fused window gather + patchify + patch embed, for Hopper (sm_90a).
//
// Replaces: _window_patchify_kernel in
// vitparticlefiltertracker_tpu/ops/patchify_pallas.py (launched by
// gather_patchify_window_pallas there). For each particle box (cx, cy, w, h)
// in window pixels it samples a crop x crop bilinear crop of the resampled
// search window (pixel-centred, clamp-to-edge), cuts it into g x g patch
// tokens of p*p*C values in the canonical (py, px, c) order of
// models/vit.py:patchify, and embeds them: tokens @ K + b -> [N, g*g, D].
// With K windows (K filter banks, each with its own search window and N
// boxes) one launch covers all K * N boxes: a box's token rows read the
// window its index falls in (box / N), which is what the JAX package's vmap
// makes of the Pallas call. The rows of all windows share the row tiles.
//
// Same arithmetic as the TPU kernel: samples in f32; tokens rounded to the
// weight's type before the product; f32 accumulation; the bias added in f32;
// one final rounding to the output type. The TPU kernel's hat weights
// max(0, 1 - |y - r|) over the whole window grid, with y clipped to
// [0, Swin - 1], are exactly the 4-tap bilinear sample at floor(y) and
// min(floor(y) + 1, Swin - 1) that this kernel reads; the sample is taken in
// ops/image.py bilinear_sample's order of operations, without FMA
// contraction, so it equals the plain version's f32 value.
//
// What bounds it on this card, at the crop path's two calls (Swin 256,
// crop 32, p 16, C 3, D 768, bf16):
//  * N 1024 (4096 token rows): operations. The embed product is 4.83 GFLOP
//    against 8.3 MB moved: 4.9 us at 989 TFLOP/s. In practice the traffic
//    from L2 to the SMs comes first: every row tile reads the whole 1.18 MB
//    weight (75 MB over 64 tiles of 64 rows), and every column slot samples
//    its rows again (about a million bilinear pixels a pass, 12 scalar taps
//    of 4 bytes each, most of them from L2).
//  * N 1 (4 token rows): bytes, the 1.18 MB weight: 0.36 us at 3.35 TB/s.
//    In practice latency, and how many SMs stream the weight at once.
//
// Design. Two kernels behind one entry; the wrapper's launch plan
// (ops/patchify_window.py, launch_plan) picks the kernel, its tile and the
// grid:
//  * mma (bf16 weights, D % 8 == 0): a block owns BM token rows and BN
//    output columns. It samples its rows once into shared memory as bf16,
//    rows padded to K + 8 elements so that ldmatrix's 8 rows fall in
//    distinct banks, while cp.async brings the first [BK, BN] weight tiles
//    of a ring. The product runs as mma.sync m16n8k16 (bf16 in, f32
//    accumulate): A by ldmatrix from the token rows, B by ldmatrix.trans from
//    the row-major weight tiles. Epilogue: the f32 bias, one rounding, and a
//    4 x 4 transpose within each quad by shuffles, so that every lane stores
//    16 contiguous bytes. Two tiles: wide (64 x 384, 16 warps of 32 x 48,
//    one block an SM, a 4-stage ring of 32-row weight tiles) when its
//    blocks cover three quarters of the SMs (N 1024: 64 row tiles x 2
//    column tiles, one wave, two sampling passes, 75 MB of weight reads),
//    narrow (16 x 32, 2 warps) otherwise; at N 1 the narrow tile splits
//    D 768 over 24 blocks that stream the weight side by side, each through
//    an 8-stage ring of 64-row tiles. A lane issues the taps of 4 pixels
//    before it blends any, to keep loads in flight.
//  * scalar (f32 weights, or D % 8 != 0): f32 FMAs from f32 tokens in shared
//    memory, 16 rows a block, 768 columns a pass. It runs only in tests and
//    tiny trackers.
// Row tiles lie on grid.x and column tiles on grid.y, one tile a block in
// the plan's grid. A block loops over both (grid-stride), sampling a row
// tile on its first column tile; so any grid is correct.
//
// Layout: window [K, Swin, Swin, C] f32, centers and sizes [K, N, 2] f32,
// kernel [p*p*C, D], bias [D] and out [K, N, g*g, D] in the weight's type
// (f32 or bf16), all contiguous (K = 1 for one window); the mma kernel
// needs kernel and out on 16 bytes.
//
// Interface: plain C, loaded with ctypes. Returns cudaGetLastError() after
// the launch (0 = success), -1 for arguments the kernels do not take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>

#include "mma_sm90.cuh"  // cp.async, ldmatrix, mma.sync m16n8k16 (bf16, f32 accumulate)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block can use

enum Path { kScalar = 0, kNarrow = 1, kWide = 2 };
enum Dtype { kF32 = 0, kBF16 = 1 };

struct Problem {
  const float* win;      // [windows, swin, swin, c]
  const float* centers;  // [windows * n, 2] (x, y)
  const float* sizes;    // [windows * n, 2] (w, h)
  const void* kern;      // [kdim, d]
  const void* bias;      // [d]
  void* out;             // [rows, d]
  int n;                 // boxes a window
  int win_elems;         // swin * swin * c: elements a window
  int swin, c, crop, patch, d;
  int g, g2, kdim, rows;  // crop / patch, g * g, patch * patch * c, windows * n * g2
};

// ---------------------------------------------------------------------------
// Sampling, shared by both kernels.
// ---------------------------------------------------------------------------

// (i + 0.5) / crop - 0.5 for i < crop, as ops/image.py _offsets.
__device__ __forceinline__ void fill_offsets(float* offs, int crop) {
  for (int i = threadIdx.x; i < crop; i += blockDim.x)
    offs[i] = __fsub_rn(__fdiv_rn(static_cast<float>(i) + 0.5f, static_cast<float>(crop)), 0.5f);
}

// Samples token rows row0 .. row0 + nrows - 1 and hands each value to
// put(r, k, v), k = (py * patch + px) * C + ch. A warp takes a row at a
// time, its lanes the row's patch pixels; with C known at compile time a
// lane issues the taps of kU pixels before it blends any, so that kU * 4 * C
// loads are in flight (the taps mostly come from L2).
template <int kC, typename Put>
__device__ __forceinline__ void sample_rows_c(const Problem& p, const float* offs, int row0, int nrows, Put put) {
  constexpr int kU = kC > 0 ? 4 : 1;
  constexpr int kCv = kC > 0 ? kC : 1;  // channels held in registers
  const int c = kC > 0 ? kC : p.c;
  const int pp = p.patch * p.patch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float smax = static_cast<float>(p.swin - 1);
  const int step_py = 32 / p.patch, step_px = 32 % p.patch;
  for (int r = warp; r < nrows; r += warps) {
    const int row = row0 + r;
    const int pid = row / p.g2;  // the box, over all windows
    const int ti = row - pid * p.g2;
    const int wbase = (pid / p.n) * p.win_elems;  // its window's first element
    const int tile_y = ti / p.g;
    const float* oy = offs + tile_y * p.patch;              // crop rows of this token
    const float* ox = offs + (ti - tile_y * p.g) * p.patch;  // crop columns
    const float cx = p.centers[2 * pid], cy = p.centers[2 * pid + 1];
    const float bw = p.sizes[2 * pid], bh = p.sizes[2 * pid + 1];
    int py = lane / p.patch, px = lane % p.patch;
    for (int q0 = lane; q0 < pp; q0 += 32 * kU) {
      float wx[kU], wy[kU];
      int top[kU], bot[kU], left[kU], right[kU];  // element offsets of the tap rows and columns
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool on = q0 + 32 * u < pp;  // a pixel past the patch samples (0, 0) and is never put
        const float ys = fminf(fmaxf(__fadd_rn(cy, __fmul_rn(bh, oy[on ? py : 0])), 0.f), smax);
        const float xs = fminf(fmaxf(__fadd_rn(cx, __fmul_rn(bw, ox[on ? px : 0])), 0.f), smax);
        const float y0f = floorf(ys), x0f = floorf(xs);
        wy[u] = __fsub_rn(ys, y0f);
        wx[u] = __fsub_rn(xs, x0f);
        const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
        top[u] = wbase + y0 * p.swin * c;
        bot[u] = wbase + min(y0 + 1, p.swin - 1) * p.swin * c;
        left[u] = x0 * c;
        right[u] = min(x0 + 1, p.swin - 1) * c;
        px += step_px;  // the next pixel of this lane: 32 further on
        py += step_py;
        if (px >= p.patch) {
          px -= p.patch;
          ++py;
        }
      }
      for (int ch0 = 0; ch0 < c; ch0 += kCv) {
        float v[kU][4][kCv];
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int ch = 0; ch < kCv; ++ch) {
            v[u][0][ch] = __ldg(p.win + top[u] + left[u] + ch0 + ch);
            v[u][1][ch] = __ldg(p.win + top[u] + right[u] + ch0 + ch);
            v[u][2][ch] = __ldg(p.win + bot[u] + left[u] + ch0 + ch);
            v[u][3][ch] = __ldg(p.win + bot[u] + right[u] + ch0 + ch);
          }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int q = q0 + 32 * u;
          if (q >= pp) break;
          const float wx1 = __fsub_rn(1.f, wx[u]), wy1 = __fsub_rn(1.f, wy[u]);
#pragma unroll
          for (int ch = 0; ch < kCv; ++ch) {
            const float t = __fadd_rn(__fmul_rn(v[u][0][ch], wx1), __fmul_rn(v[u][1][ch], wx[u]));
            const float b = __fadd_rn(__fmul_rn(v[u][2][ch], wx1), __fmul_rn(v[u][3][ch], wx[u]));
            put(r, q * c + ch0 + ch, __fadd_rn(__fmul_rn(t, wy1), __fmul_rn(b, wy[u])));
          }
        }
      }
    }
  }
}

template <typename Put>
__device__ __forceinline__ void sample_rows(const Problem& p, const float* offs, int row0, int nrows, Put put) {
  if (p.c == 3)
    sample_rows_c<3>(p, offs, row0, nrows, put);  // RGB: the channel loop unrolled
  else
    sample_rows_c<0>(p, offs, row0, nrows, put);
}

// ---------------------------------------------------------------------------
// mma kernel: bf16 tokens and weights on tensor cores.
// ---------------------------------------------------------------------------

// kWM x kWN warps; each warp owns kMT m16 row tiles by kNT n8 column tiles.
// kBK weight rows a ring stage, kStages stages.
template <int kWM_, int kWN_, int kMT_, int kNT_, int kBK_, int kStages_, int kMinBlocks_>
struct MmaTile {
  static constexpr int kWM = kWM_, kWN = kWN_, kMT = kMT_, kNT = kNT_;
  static constexpr int kBK = kBK_, kStages = kStages_, kMinBlocks = kMinBlocks_;
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int kBM = 16 * kMT * kWM;
  static constexpr int kBN = 8 * kNT * kWN;
  static constexpr int kBPitch = kBN + 8;  // bf16 pitch of a weight row in the ring
  static_assert(kNT % 2 == 0, "B fragments come two n8 tiles at a time; the epilogue's words four at a time");
  static_assert(kBK % 16 == 0 && kStages >= 2, "ring");
};
using WideTile = MmaTile<2, 8, 2, 6, 32, 4, 1>;    // 64 x 384, 16 warps of 32 x 48
using NarrowTile = MmaTile<1, 2, 1, 2, 64, 8, 1>;  // 16 x 32, 2 warps of 16 x 16

// Token pitch (elements) of the mma kernel's rows: K padded to the ring's
// depth, plus 8, so that a row is an odd number of 16-byte chunks.
template <class Tile>
__host__ __device__ __forceinline__ long long mma_token_pitch(long long kdim) {
  return (kdim + Tile::kBK - 1) / Tile::kBK * Tile::kBK + 8;
}

template <class Tile>
long long mma_smem_bytes(long long kdim, int crop) {
  return 2LL * (Tile::kStages * Tile::kBK * Tile::kBPitch + Tile::kBM * mma_token_pitch<Tile>(kdim)) + 4LL * crop;
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Within each quad: lane tq ends with word tq of lanes 0..3 of its quad,
// in lane order (v[s] = lane s's v[tq]).
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int lane) {
  const int tq = lane & 3, base = lane & ~3;
  uint32_t t[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int src = (tq - r) & 3;  // sends its word (src + r) & 3 == tq this round
    const uint32_t got = __shfl_sync(0xffffffffu, pick4(v, (tq + r) & 3), base | src);
#pragma unroll
    for (int s = 0; s < 4; ++s) t[s] = s == src ? got : t[s];
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) v[s] = t[s];
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + tq.
// A (16x16, row): a0 = A[g][2tq..], a1 = A[g+8][2tq..], a2 = A[g][2tq+8..],
// a3 = A[g+8][2tq+8..]. B (16x8, col): b0 = B[2tq..][g], b1 = B[2tq+8..][g].
// C (16x8): c0, c1 = C[g][2tq..], c2, c3 = C[g+8][2tq..].
template <class Tile>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
window_patchify_mma_kernel(const Problem p) {
  constexpr int kBM = Tile::kBM, kBN = Tile::kBN, kBK = Tile::kBK, kStages = Tile::kStages;
  constexpr int kMT = Tile::kMT, kNT = Tile::kNT, kBPitch = Tile::kBPitch, kThreads = Tile::kThreads;
  extern __shared__ __align__(16) unsigned char vpt_smem[];
  const int apitch = static_cast<int>(mma_token_pitch<Tile>(p.kdim));
  const int kpad = apitch - 8;
  bf16* bs = reinterpret_cast<bf16*>(vpt_smem);                // [kStages][kBK][kBPitch]
  bf16* as = bs + kStages * kBK * kBPitch;                      // [kBM][apitch]
  float* offs = reinterpret_cast<float*>(as + kBM * apitch);    // [crop]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, mat = lane >> 3, mr = lane & 7;
  const int wrow = (warp / Tile::kWN) * kMT * 16;  // the warp's first row and column in the tile
  const int wcol = (warp % Tile::kWN) * kNT * 8;
  const int row_tiles = (p.rows + kBM - 1) / kBM;
  const int col_tiles = (p.d + kBN - 1) / kBN;
  const int k_tiles = kpad / kBK;
  const bf16* kern = static_cast<const bf16*>(p.kern);
  const bf16* bias = static_cast<const bf16*>(p.bias);
  bf16* out = static_cast<bf16*>(p.out);

  // Weight rows kt*kBK .. +kBK, columns n0 .. n0+kBN into ring stage `stage`;
  // rows past K and columns past D are zero-filled.
  auto load_b = [&](int stage, int kt, int n0) {
    constexpr int kChunks = kBN / 8;  // 16-byte chunks a row
    bf16* dst = bs + stage * kBK * kBPitch;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, cc = (i % kChunks) * 8;
      const int k = kt * kBK + r, col = n0 + cc;
      const bool ok = k < p.kdim && col < p.d;
      cp_async16(dst + r * kBPitch + cc, ok ? kern + static_cast<size_t>(k) * p.d + col : kern, ok);
    }
  };

  fill_offsets(offs, p.crop);
  for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int row0 = rt * kBM;
    const int live = min(kBM, p.rows - row0);
    for (int ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
      const int n0 = ct * kBN;
      __syncthreads();  // every warp is done with the ring, and with the rows before a resample
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < k_tiles) load_b(s, s, n0);
        cp_async_commit();
      }
      if (ct == blockIdx.y) {  // while the first weight tiles are in flight
        sample_rows(p, offs, row0, live,
                    [&](int r, int k, float v) { as[r * apitch + k] = __float2bfloat16_rn(v); });
        for (int i = tid; i < live * (kpad - p.kdim); i += kThreads) {
          const int w = kpad - p.kdim;
          as[(i / w) * apitch + p.kdim + i % w] = __float2bfloat16_rn(0.f);
        }
        // Rows past `live` are left as they are: a row of A reaches only
        // its own row of C, and those rows are never stored.
      }

      float acc[kMT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

      for (int kt = 0; kt < k_tiles; ++kt) {
        cp_async_wait<kStages - 2>();  // stage kt has landed
        __syncthreads();               // for every thread; and stage kt - 1 is free again
        const int next = kt + kStages - 1;
        if (next < k_tiles) load_b(next % kStages, next, n0);
        cp_async_commit();
        const bf16* bt = bs + (kt % kStages) * kBK * kBPitch;
        const bf16* at = as + kt * kBK;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t af[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            ldmatrix_x4(af[mt], at + (wrow + mt * 16 + mr + (mat & 1) * 8) * apitch + kk + (mat >> 1) * 8);
#pragma unroll
          for (int nt = 0; nt < kNT; nt += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bt + (kk + mr + (mat & 1) * 8) * kBPitch + wcol + nt * 8 + (mat >> 1) * 8);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              mma_bf16(acc[mt][nt], af[mt], b[0], b[1]);
              mma_bf16(acc[mt][nt + 1], af[mt], b[2], b[3]);
            }
          }
        }
      }

      // Epilogue: + bias in f32, one rounding. A lane's words (bf16 pairs)
      // are numbered w = rh * kNT + nt (row half g / g+8, n8 tile); after
      // the quad transpose of words 4j .. 4j+3, lane tq holds all 8
      // columns of word 4j + tq: one 16-byte store.
      float bv[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + wcol + nt * 8 + 2 * tq;
        const bool ok = col < p.d;  // D % 8 == 0: a column pair is in or out with its 8-column block
        bv[nt][0] = ok ? __bfloat162float(bias[col]) : 0.f;
        bv[nt][1] = ok ? __bfloat162float(bias[col + 1]) : 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int w = 4 * j + e, rh = w / kNT, nt = w % kNT;
            v[e] = pack_bf16(acc[mt][nt][2 * rh] + bv[nt][0], acc[mt][nt][2 * rh + 1] + bv[nt][1]);
          }
          quad_transpose(v, lane);
          const int w = 4 * j + tq, rh = w / kNT, nt = w % kNT;
          const int row = row0 + wrow + mt * 16 + g + 8 * rh;
          const int col = n0 + wcol + nt * 8;
          if (row < p.rows && col < p.d)
            *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * p.d + col) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// scalar kernel: f32 FMAs (f32 weights, or a D the mma kernel does not take).
// ---------------------------------------------------------------------------

constexpr int kScalarRows = 16;     // token rows a block
constexpr int kScalarThreads = 256;
constexpr int kScalarCols = 3;      // output columns a thread a pass
constexpr int kScalarBN = kScalarThreads * kScalarCols;  // 768 columns a column tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// A token value as the embed product sees it: rounded to the weight's type.
template <typename T> __device__ __forceinline__ float as_weight_type(float v);
template <> __device__ __forceinline__ float as_weight_type<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_weight_type<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ __forceinline__ long long scalar_token_pitch(long long kdim) { return (kdim + 3) & ~3LL; }

long long scalar_smem_bytes(long long kdim, int crop) {
  return 4LL * (kScalarRows * scalar_token_pitch(kdim) + crop);
}

// Thread t owns columns t, t + 256 and t + 512 of each 768-column tile and
// keeps 16 x 3 accumulators; per 4 reduction steps it reads 12 weights from
// global memory and 16 float4s of tokens from shared memory (broadcast).
template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
window_patchify_scalar_kernel(const Problem p) {
  extern __shared__ __align__(16) unsigned char vpt_smem[];
  const int kstride = static_cast<int>(scalar_token_pitch(p.kdim));
  float* tok = reinterpret_cast<float*>(vpt_smem);  // [kScalarRows][kstride]
  float* offs = tok + kScalarRows * kstride;         // [crop]
  const T* kern = static_cast<const T*>(p.kern);
  const T* bias = static_cast<const T*>(p.bias);
  T* out = static_cast<T*>(p.out);
  const int row_tiles = (p.rows + kScalarRows - 1) / kScalarRows;
  const int col_tiles = (p.d + kScalarBN - 1) / kScalarBN;

  fill_offsets(offs, p.crop);
  for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int row0 = rt * kScalarRows;
    const int live = min(kScalarRows, p.rows - row0);
    bool sampled = false;  // a flag, not ct == blockIdx.y as above: with that, ptxas spills 20 B here
    for (int ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
      __syncthreads();  // every thread is done with the rows before a resample
      if (!sampled) {
        sample_rows(p, offs, row0, live,
                    [&](int r, int k, float v) { tok[r * kstride + k] = as_weight_type<T>(v); });
        for (int i = threadIdx.x; i < live * (kstride - p.kdim); i += kScalarThreads) {
          const int w = kstride - p.kdim;
          tok[(i / w) * kstride + p.kdim + i % w] = 0.f;  // pad columns up to a float4
        }
        sampled = true;
        __syncthreads();
      }
      int col[kScalarCols];
      bool ok[kScalarCols];
#pragma unroll
      for (int j = 0; j < kScalarCols; ++j) {
        col[j] = ct * kScalarBN + threadIdx.x + j * kScalarThreads;
        ok[j] = col[j] < p.d;
      }
      float acc[kScalarRows][kScalarCols];
#pragma unroll
      for (int r = 0; r < kScalarRows; ++r)
#pragma unroll
        for (int j = 0; j < kScalarCols; ++j) acc[r][j] = 0.f;

      for (int k = 0; k < kstride; k += 4) {
        float w[4][kScalarCols];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < kScalarCols; ++j)
            w[kk][j] = (ok[j] && k + kk < p.kdim) ? to_f32(kern[static_cast<size_t>(k + kk) * p.d + col[j]]) : 0.f;
#pragma unroll
        for (int r = 0; r < kScalarRows; ++r) {
          const float4 t = *reinterpret_cast<const float4*>(tok + r * kstride + k);
#pragma unroll
          for (int j = 0; j < kScalarCols; ++j) {
            float a = acc[r][j];
            a = fmaf(t.x, w[0][j], a);
            a = fmaf(t.y, w[1][j], a);
            a = fmaf(t.z, w[2][j], a);
            a = fmaf(t.w, w[3][j], a);
            acc[r][j] = a;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kScalarCols; ++j) {
        if (!ok[j]) continue;
        const float b = to_f32(bias[col[j]]);
#pragma unroll
        for (int r = 0; r < kScalarRows; ++r)
          if (r < live) out[static_cast<size_t>(row0 + r) * p.d + col[j]] = from_f32<T>(acc[r][j] + b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Dynamic shared memory of one block of `path`, or -1 for an unknown path.
long long smem_bytes(int path, long long kdim, int crop) {
  if (path == kScalar) return scalar_smem_bytes(kdim, crop);
  if (path == kNarrow) return mma_smem_bytes<NarrowTile>(kdim, crop);
  if (path == kWide) return mma_smem_bytes<WideTile>(kdim, crop);
  return -1;
}

template <typename F>
int launch(F* kernel, int* configured, dim3 grid, int threads, int smem, cudaStream_t s, const Problem& p) {
  if (smem > *configured) {  // dynamic shared memory the attribute allows so far
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    *configured = smem;
  }
  kernel<<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n boxes in each of `windows` windows. dtype (of kern, bias and out): 0 =
// float32, 1 = bfloat16. path: 0 =
// scalar, 1 = narrow mma, 2 = wide mma (bf16, D % 8 == 0, kern and out on
// 16 bytes). grid_x row-tile slots, grid_y column-tile slots; the kernels
// loop over the rest, so any grid >= 1 is correct.
int vpt_window_patchify_fwd(const void* win, const void* centers, const void* sizes, const void* kern,
                            const void* bias, void* out, int n, int windows, int swin, int c, int crop, int patch,
                            int d, int dtype, int path, int grid_x, int grid_y, void* stream) {
  if (n <= 0 || windows <= 0 || swin <= 0 || c <= 0 || patch <= 0 || crop < patch || crop % patch != 0 ||
      d <= 0 || grid_x <= 0 || grid_y <= 0 || grid_y > 65535 || (dtype != kF32 && dtype != kBF16))
    return -1;
  const long long g = crop / patch;
  const long long rows = static_cast<long long>(windows) * n * g * g;
  const long long kdim = static_cast<long long>(patch) * patch * c;
  const long long smem = smem_bytes(path, kdim, crop);
  const long long win_elems = static_cast<long long>(swin) * swin * c;
  if (rows > INT_MAX || win_elems * windows > INT_MAX || smem < 0 || smem > kMaxSmemBytes) return -1;
  if (path != kScalar && (dtype != kBF16 || d % 8 != 0 || reinterpret_cast<uintptr_t>(kern) % 16 != 0 ||
                          reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return -1;
  Problem p;
  p.win = static_cast<const float*>(win);
  p.centers = static_cast<const float*>(centers);
  p.sizes = static_cast<const float*>(sizes);
  p.kern = kern;
  p.bias = bias;
  p.out = out;
  p.n = n;
  p.win_elems = static_cast<int>(win_elems);
  p.swin = swin;
  p.c = c;
  p.crop = crop;
  p.patch = patch;
  p.d = d;
  p.g = static_cast<int>(g);
  p.g2 = static_cast<int>(g * g);
  p.kdim = static_cast<int>(kdim);
  p.rows = static_cast<int>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  const int bytes = static_cast<int>(smem);
  if (path == kWide) {
    static int configured = 0;
    return launch(window_patchify_mma_kernel<WideTile>, &configured, grid, WideTile::kThreads, bytes, s, p);
  }
  if (path == kNarrow) {
    static int configured = 0;
    return launch(window_patchify_mma_kernel<NarrowTile>, &configured, grid, NarrowTile::kThreads, bytes, s, p);
  }
  if (dtype == kF32) {
    static int configured = 0;
    return launch(window_patchify_scalar_kernel<float>, &configured, grid, kScalarThreads, bytes, s, p);
  }
  static int configured = 0;
  return launch(window_patchify_scalar_kernel<bf16>, &configured, grid, kScalarThreads, bytes, s, p);
}

// Dynamic shared memory one block of `path` asks for at this patch size,
// channel count and crop size (-1 for an unknown path or past the 227 KB a
// block can use), so a caller can check and print it.
int vpt_window_patchify_smem_bytes(int path, int patch, int c, int crop) {
  if (patch <= 0 || c <= 0 || crop <= 0) return -1;
  const long long b = smem_bytes(path, static_cast<long long>(patch) * patch * c, crop);
  return (b < 0 || b > kMaxSmemBytes) ? -1 : static_cast<int>(b);
}

}  // extern "C"
