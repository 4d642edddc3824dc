// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, f32 math, output in
// the input dtype.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py :: rmsnorm_2d (Pallas,
// rows tiled through VMEM).
//
// Bound on the H100: memory bytes. Each element is read, squared and summed,
// then scaled once: a few operations per 2-4 bytes, far below the ~295
// operations per byte where the card stops being bound by its memory. At the
// serving path's shapes (8 to 32 rows of D = 960) a call moves 15-60 KB, so
// what it costs on the card is its latency: one dependent chain of loads, a
// reduction and stores.
//
// Design, two paths chosen by the entry point from D and the pointers:
// - One warp per row, where 16-byte vectors (8 bf16 or 4 f32) tile the row
//   and a lane holds at most kMaxVec of them (D <= 2048 in bf16, <= 1024 in
//   f32; D = 960 bf16 is 120 vectors, at most 4 per lane). The warp loads
//   its whole row and w into registers at once (one round trip to memory),
//   so x is read once; the sum of squares is reduced with xor-shuffles only
//   (no shared memory, no __syncthreads); then the row is stored.
//   kRowsPerBlock warps, each on its own row, share a block.
// - Otherwise (a ragged or wider D, or an unaligned pointer) one block of
//   128 threads per row: 16-byte or single-element loads, a shuffle and
//   shared-memory reduction, and a second pass over the row, which is
//   still in L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxVec = 8;  // 16-byte vectors per lane on the one-warp path

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NV (4 or kMaxVec) vectors per lane: d / VEC <= 32 * NV.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  using P = rt::Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(rows)) return;  // whole warps leave together
  const int nvec = d / VEC;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + row * d);

  P p[NV], pw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {  // x and w loaded before any arithmetic: one round trip
    const int i = lane + 32 * j;
    if (i < nvec) {
      p[j] = xr[i];
      pw[j] = wr[i];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = rt::to_f(p[j].v[e]);
        ss += f * f;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        o.v[e] = rt::from_f<T>(rt::to_f(p[j].v[e]) * inv * rt::to_f(pw[j].v[e]));
      }
      orow[i] = o;
    }
  }
}

__device__ float block_sum(float v) {
  __shared__ float red[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

template <typename T, int VEC>
__global__ void rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                     T* __restrict__ out, int d, float eps) {
  using P = rt::Pack<T, VEC>;
  const size_t row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + row * d);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const P p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = rt::to_f(p.v[j]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const P p = xr[i];
    const P pw = wr[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      o.v[j] = rt::from_f<T>(rt::to_f(p.v[j]) * inv * rt::to_f(pw.v[j]));
    }
    orow[i] = o;
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int rows, int d, float eps,
            cudaStream_t stream) {
  constexpr int V16 = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const bool vec = d % V16 == 0 && rt::aligned(x, 16) && rt::aligned(w, 16) &&
                   rt::aligned(out, 16);
  const int nvec = d / V16;
  const int warp_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec && nvec <= 32 * 4) {
    rmsnorm_warp_kernel<T, 4><<<warp_blocks, kThreads, 0, stream>>>(xp, wp, op, rows, d, eps);
  } else if (vec && nvec <= 32 * kMaxVec) {
    rmsnorm_warp_kernel<T, kMaxVec><<<warp_blocks, kThreads, 0, stream>>>(xp, wp, op, rows, d,
                                                                           eps);
  } else if (vec) {
    rmsnorm_block_kernel<T, V16><<<rows, kThreads, 0, stream>>>(xp, wp, op, d, eps);
  } else {
    rmsnorm_block_kernel<T, 1><<<rows, kThreads, 0, stream>>>(xp, wp, op, d, eps);
  }
}

}  // namespace

// x, out: (rows, d) contiguous; w: (d,) of the same dtype.
extern "C" int rt_rmsnorm(const void* x, const void* w, void* out, int rows, int d,
                          float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (dtype == rt::kBF16) {
      launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
    } else {
      launch<float>(x, w, out, rows, d, eps, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
