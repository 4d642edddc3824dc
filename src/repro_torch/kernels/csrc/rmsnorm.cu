// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, f32 math, output in
// the input dtype.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py :: rmsnorm_2d (Pallas,
// rows tiled through VMEM).
//
// Bound on the H100: memory bytes. Each element is read, squared and summed,
// then scaled once: a few operations per 2-4 bytes, far below the ~295
// operations per byte where the card stops being bound by its memory.
//
// Design: one block of 128 threads per row. Loads and stores move 16 bytes
// per thread (8 bf16 or 4 f32) where the row allows it, else one element.
// D = 960 is no power of two: the loop bound masks the threads past the last
// vector (120 vectors of 8 bf16 on 128 threads). The sum of squares is
// reduced with warp shuffles and one shared-memory step across warps. The
// second pass re-reads the row, which is still in L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ float block_sum(float v) {
  __shared__ float red[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

template <typename T, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
  if (vec) {
    rmsnorm_kernel<T, V16><<<rows, kThreads, 0, stream>>>(xp, wp, op, d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<rows, kThreads, 0, stream>>>(xp, wp, op, d, eps);
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
