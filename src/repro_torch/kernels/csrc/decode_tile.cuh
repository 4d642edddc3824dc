// The flash-decoding step shared by the two decode kernels (the paged one of
// paged_attention.cu and the dense one of decode_attention.cu): one tile of
// keys, already staged in shared memory as f32, updates the online softmax
// of the G query heads that share one KV head.
//
// One block of kDecThreads threads per (sequence, KV head). Threads g < G
// keep query head g's running max and sum in registers; every thread keeps
// its share (at most kMaxPerThread elements) of the G x hd accumulator in
// registers. G and hd are runtime values; G need not be a power of two.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kDecThreads = 128;
constexpr int kMaxPerThread = 4;  // G * hd <= 512

struct DecodeSmem {
  float* q;  // G * hd
  float* k;  // tile * (hd + 1): rows padded so the score loop's lanes hit distinct banks
  float* v;  // tile * hd
  float* p;  // G * tile: scores, then probabilities
  float* c;  // G: per-tile correction, then the sums
};

inline size_t decode_smem_bytes(int G, int hd, int tile) {
  return sizeof(float) * (static_cast<size_t>(G) * hd + static_cast<size_t>(tile) * (hd + 1) +
                          static_cast<size_t>(tile) * hd + static_cast<size_t>(G) * tile + G);
}

__device__ __forceinline__ DecodeSmem decode_smem(float* sm, int G, int hd, int tile) {
  DecodeSmem s;
  s.q = sm;
  s.k = s.q + G * hd;
  s.v = s.k + tile * (hd + 1);
  s.p = s.v + tile * hd;
  s.c = s.p + G * tile;
  return s;
}

struct DecodeState {
  float acc[kMaxPerThread];
  float m_run, l_run;  // live on threads tid < G

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;
    m_run = kNegInf;
    l_run = 0.f;
  }
};

// Rows [0, n) of s.k and s.v hold the keys and values at positions
// t0 .. t0 + n - 1; positions >= len are masked. The softcap is applied
// before the mask, as the TPU kernel does. Ends with a barrier, so the
// caller may stage the next tile straight away.
__device__ __forceinline__ void decode_tile(const DecodeSmem& s, DecodeState& st, int n, int t0,
                                            int len, int G, int hd, float scale, float softcap) {
  const int tid = threadIdx.x;
  const int LDK = hd + 1;
  for (int idx = tid; idx < G * n; idx += blockDim.x) {
    const int g = idx / n, t = idx % n;
    const float* qr = s.q + g * hd;
    const float* kr = s.k + t * LDK;
    float dot = 0.f;
    for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
    float sc = dot * scale;
    if (softcap != 0.f) sc = tanhf(sc / softcap) * softcap;
    if (t0 + t >= len) sc = kNegInf;
    s.p[idx] = sc;
  }
  __syncthreads();

  if (tid < G) {
    float* pr = s.p + tid * n;
    float mx = st.m_run;
    for (int t = 0; t < n; ++t) mx = fmaxf(mx, pr[t]);
    const float corr = expf(st.m_run - mx);
    float sum = 0.f;
    for (int t = 0; t < n; ++t) {
      const float p = expf(pr[t] - mx);
      pr[t] = p;
      sum += p;
    }
    st.l_run = st.l_run * corr + sum;
    st.m_run = mx;
    s.c[tid] = corr;
  }
  __syncthreads();

  const int GH = G * hd;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int e = tid + j * kDecThreads;
    if (e < GH) {
      const int g = e / hd, d = e % hd;
      const float* pr = s.p + g * n;
      float a = st.acc[j] * s.c[g];
      for (int t = 0; t < n; ++t) a += pr[t] * s.v[t * hd + d];
      st.acc[j] = a;
    }
  }
  __syncthreads();  // the next tile overwrites k, v, p and c
}

// out (G x hd of this block) = acc / max(l, 1e-30): a block that saw no
// tile (length 0) writes zeros, as the TPU kernels' finalize does.
template <typename T>
__device__ __forceinline__ void decode_finalize(const DecodeSmem& s, const DecodeState& st,
                                                T* out, int G, int hd) {
  const int tid = threadIdx.x;
  if (tid < G) s.c[tid] = st.l_run;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int e = tid + j * kDecThreads;
    if (e < G * hd) out[e] = from_f<T>(st.acc[j] / fmaxf(s.c[e / hd], 1e-30f));
  }
}

}  // namespace rt
