// The tracker step's random draws, made on the card inside the step's CUDA
// graph: one launch writes every bank's position, velocity and scale normals
// and its resampling uniform (filters/particle.py StepNoise), and, where
// global re-detection is configured, its reseed normals.
//
// The draws are bitwise those of filters/particle.py draw_step_noise and
// draw_reseed_noise, which make them with torch's CUDA generator: a
// torch.Generator a (seed, stream), seeded with
// splitmix64(splitmix64(seed) ^ stream), the stream being the frame index (or
// RESEED_STREAM | frame index for the reseed), then torch.randn and torch.rand
// in a fixed order. This kernel redoes what torch's launches do
// (ATen/native/cuda/DistributionTemplates.h), with curand's own device
// functions:
//   - a draw of `numel` floats runs torch's grid-stride kernel with blocks of
//     256 threads and a grid of min(SMs * maxThreadsPerSM / 256,
//     ceil(numel / 256)) blocks; thread t calls curand_init(seed, t, offset)
//     and then curand_normal4 (or curand_uniform4) once for each pass of its
//     loop; element t + S (4 j + i), S = 256 * grid, is component i of its
//     j-th call;
//   - each draw advances the generator's Philox offset by
//     ((numel - 1) / (4 S) + 1) * 4, starting from 0 after manual_seed;
//   - a normal is written as rand * 1 + 0 (so -0 reads +0), a uniform as
//     rand * 1 + 0 with 1 mapped to 0 (curand's (0, 1] to torch's [0, 1)).
// The grids and offsets come from the host (ops/step_noise.py draw_plan), so
// this file holds no launch policy of its own. Threads of torch's grid that
// write no element are skipped: their draws reach no output.
//
// One work item is one (bank, draw, torch thread): its key is hashed, its
// Philox state set and its elements written, independently of every other
// item, so a plain grid-stride loop over all items of all banks does the
// whole step's noise in one launch. Bank b = c * K + k of a chunk of C steps
// reads key k (seed, frame index) and draws frame index + c.
//
// Plain C interface, loaded with ctypes (ops/_build.py); built without
// --use_fast_math, as torch's own kernels are.

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

constexpr int kParts = 5;  // pos, vel, scale, resample_u, reseed
constexpr int kBlock = 256;
constexpr unsigned long long kReseedStream = 1ull << 32;  // filters/particle.py RESEED_STREAM

struct Part {
  float* out;                 // [C, K, numel], contiguous
  long long numel;            // elements a bank
  long long stride;           // torch's threads for this draw: 256 * grid
  long long items;            // those that write an element: min(stride, numel)
  unsigned long long offset;  // the generator's Philox offset at this draw
  int normal;                 // curand_normal4, else curand_uniform4
  int reseed;                 // keyed on RESEED_STREAM | frame index
};

struct Plan {
  Part part[kParts];
  int parts;
  int k;               // keys: banks a step
  long long banks;     // C * K
  long long per_bank;  // work items a bank: the parts' items summed
};

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void __launch_bounds__(kBlock) step_noise_kernel(const long long* __restrict__ keys, const Plan plan) {
  const long long total = plan.banks * plan.per_bank;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kBlock) {
    const long long b = i / plan.per_bank;
    long long t = i - b * plan.per_bank;
    // The item's draw, picked with static indices so the plan stays in
    // parameter space (a dynamic index would copy it to local memory).
    Part part = plan.part[0];
#pragma unroll
    for (int q = 1; q < kParts; ++q) {
      if (q < plan.parts && t >= part.items) {
        t -= part.items;
        part = plan.part[q];
      }
    }
    const long long c = b / plan.k;
    const long long k = b - c * plan.k;
    const unsigned long long frame = static_cast<unsigned long long>(keys[2 * k + 1] + c);
    const unsigned long long stream = part.reseed ? (kReseedStream | frame) : frame;
    const unsigned long long seed = splitmix64(splitmix64(static_cast<unsigned long long>(keys[2 * k])) ^ stream);
    curandStatePhilox4_32_10_t state;
    curand_init(seed, static_cast<unsigned long long>(t), part.offset, &state);
    float* out = part.out + b * part.numel;
    for (long long base = t; base < part.numel; base += 4 * part.stride) {
      const float4 r = part.normal ? curand_normal4(&state) : curand_uniform4(&state);
      const float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = base + j * part.stride;
        if (e < part.numel) {
          const float x = __fadd_rn(v[j], 0.0f);  // torch's rand * 1 + 0: -0 becomes +0
          out[e] = (part.normal || x != 1.0f) ? x : 0.0f;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// keys: [K, 2] int64 (seed, frame index) on the card; out: pos, vel, scale,
// resample_u and reseed, each [C, K, numel] f32 contiguous (reseed null: not
// drawn); n: particles; grid2 / grid1: torch's grids for a draw of 2 n and of
// n floats; off_vel, off_scale, off_u: the Philox offsets of the velocity,
// scale and uniform draws (position and reseed start at 0); blocks: this
// launch's grid; stream: the stream to launch on. Returns a cudaError_t
// value (0 = success).
int vpt_step_noise(const void* keys, int c, int k, long long n, void* pos, void* vel, void* scale, void* u,
                   void* reseed, int grid2, int grid1, long long off_vel, long long off_scale, long long off_u,
                   int blocks, void* stream) {
  if (c < 1 || k < 1 || n < 1 || grid2 < 1 || grid1 < 1 || blocks < 1) return cudaErrorInvalidValue;
  Plan plan{};
  const long long s2 = static_cast<long long>(kBlock) * grid2;
  const long long s1 = static_cast<long long>(kBlock) * grid1;
  const long long n2 = 2 * n;
  auto part = [](void* out, long long numel, long long stride, long long offset, int normal, int re) {
    return Part{static_cast<float*>(out), numel, stride, numel < stride ? numel : stride,
                static_cast<unsigned long long>(offset), normal, re};
  };
  plan.part[0] = part(pos, n2, s2, 0, 1, 0);
  plan.part[1] = part(vel, n2, s2, off_vel, 1, 0);
  plan.part[2] = part(scale, n, s1, off_scale, 1, 0);
  plan.part[3] = part(u, 1, kBlock, off_u, 0, 0);
  plan.parts = 4;
  if (reseed != nullptr) plan.part[plan.parts++] = part(reseed, n2, s2, 0, 1, 1);
  plan.k = k;
  plan.banks = static_cast<long long>(c) * k;
  for (int p = 0; p < plan.parts; ++p) plan.per_bank += plan.part[p].items;
  step_noise_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), plan);
  return cudaGetLastError();
}

}  // extern "C"
