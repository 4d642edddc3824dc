// The warp-level machinery of the two decode kernels (the dense one of
// decode_attention.cu and the paged one of paged_attention.cu): one query
// token per sequence, G query heads sharing one KV head, keys read straight
// from device memory into registers.
//
// - Warps across keys, lanes across hd. LPR lanes cover one key row with one
//   vector load each (16 bytes of f32 or bf16, 8 bytes of int8), so a warp
//   covers RPW = 32 / LPR rows per step. Each warp takes chunks of
//   kUnroll * RPW consecutive rows, round-robin with the other warps, and
//   loads the next chunk's K and V (and, for int8, each row's two scales)
//   before it computes on the current one, so several loads per lane are in
//   flight. Where a row lies is the caller's: an index functor maps a row
//   (a token position) to the row's index in its storage, and the row's
//   elements start at index * row_stride.
// - A block takes one group of at most GM of the G query heads of its KV
//   head: GM is a template width (3 where G = 3, 4 where G <= 4, 8 where
//   G <= 8), and G > 8 is split into ceil(G / 4) head groups of GM = 4,
//   each a block of its own in the grid (HeadGroup). The group's query rows
//   live in registers (each lane its VEC columns): GM = 8 at hd 128 in
//   bf16 already fills the 255 registers a thread may hold and spills, and
//   at glm4-9b's serving shapes (G = 16) groups of 4 ran 1.2-1.6x faster
//   than groups of 8 on an H100 (scripts/decode_groups_timing.py: twice the
//   blocks, no spill; slower only at 4096-token rows, where they get half
//   the splits). The groups of one (b, KV head, split) are neighbours in
//   the grid, so the later groups' K/V rows come mostly from L2.
// - A dot product is reduced with xor-shuffles among the LPR lanes of a
//   row. Each group of LPR lanes keeps its own online softmax (m, l) and
//   accumulator per query head, over the rows it reads, in registers, with
//   scores in base 2 (times log2 e) so that each exponential is one exp2f.
//   Heads past the group's last run on zero query rows and are never
//   stored, so a chunk's heads and rows unroll into independent chains
//   without branches.
// - An int8 row is dequantized in registers, f32(int8) * f32(scale), the
//   arithmetic of models/quant.py's dequantize_kv, one scale per row.
// - One merge at the end: the row groups of a warp by xor-shuffles, then the
//   warps through shared memory, in a fixed order. With a split of the keys
//   across blocks, each split writes its (m, l, acc) in f32 (each head group
//   its own heads' slice of the split's G x (hd + 2) floats) and
//   combine_kernel merges the splits of all G heads in split order:
//   deterministic, with no float atomics. A split that sees no row writes
//   m = -inf and l = 0, and a sequence that sees none yields 0.
#pragma once

#include <string.h>

#include "common.cuh"

namespace rt {
namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;            // row steps per chunk; two chunks' loads in flight
constexpr int kCombineThreads = 256;  // strided over the G * hd outputs (2048 at G 16, hd 128)
constexpr float kLog2e = 1.4426950408889634f;

// One lane's vector of a row: a 16- or 8-byte load through the read-only
// path, or a narrower one on the general path.
template <typename P>
__device__ __forceinline__ P load_vec(const void* p) {
  P out;
  if constexpr (sizeof(P) == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &r, sizeof(P));
  } else if constexpr (sizeof(P) == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(&out, &r, sizeof(P));
  } else {
    out = *reinterpret_cast<const P*>(p);
  }
  return out;
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// 2^(a - b) with 2^(-inf - anything) = 0, also when both are -inf.
__device__ __forceinline__ float rescale(float a, float b) {
  return a == neg_inf() ? 0.f : exp2f(a - b);
}

// The head group of block index x: groups of one (b, KV head, split) are
// neighbours, x = (bh * nsplit + split) * n_groups + group.
struct HeadGroup {
  int bh, split, g0, n;   // (b, KV head), split, first head, heads in the group

  template <int GM>
  __device__ __forceinline__ static HeadGroup of(int x, int G, int nsplit) {
    const int n_groups = (G + GM - 1) / GM;
    const int group = x % n_groups, rest = x / n_groups;
    const int g0 = group * GM;
    return {rest / nsplit, rest % nsplit, g0, G - g0 < GM ? G - g0 : GM};
  }
};

// The online-softmax state of one lane: its VEC columns of GM query heads,
// over the rows its group of LPR lanes has read.
template <int GM, int VEC>
struct Softmax {
  float m[GM], l[GM], acc[GM][VEC];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = neg_inf();
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }
  }
};

// A lane holds VEC consecutive elements of a row at column col * VEC; a row
// is LPR lanes (hd <= LPR * VEC; lanes past hd hold zeros). TS is the
// storage type (float, bf16, or int8 with bf16 scales).
template <typename TS, int VEC, int LPR, int GM>
struct Tile {
  static constexpr int RPW = 32 / LPR;             // rows a warp covers per step
  static constexpr int CHUNK = kUnroll * RPW;      // rows per warp per chunk
  static constexpr bool kQuant = std::is_same<TS, int8_t>::value;
  using P = rt::Pack<TS, VEC>;

  P k[kUnroll] = {}, v[kUnroll] = {};
  float ks[kUnroll] = {}, vs[kUnroll] = {};        // int8 only: the rows' scales

  // Rows t + u * RPW + sub (u < kUnroll) of this lane's column; rows at or
  // past ``end``, and columns past hd, are not read. ``index(row)`` is the
  // row's index in the storage; kb/vb point at this lane's column of index 0.
  template <typename Index>
  __device__ __forceinline__ void load(const TS* kb, const TS* vb,
                                       const __nv_bfloat16* __restrict__ ksb,
                                       const __nv_bfloat16* __restrict__ vsb,
                                       long long row_stride, const Index& index, int t, int sub,
                                       int end, bool active) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = t + u * RPW + sub;
      if (active && row < end) {
        const long long i = index(row);
        k[u] = load_vec<P>(kb + i * row_stride);
        v[u] = load_vec<P>(vb + i * row_stride);
        if constexpr (kQuant) {
          ks[u] = __bfloat162float(ksb[i]);
          vs[u] = __bfloat162float(vsb[i]);
        }
      }
    }
  }

  __device__ __forceinline__ float kval(int u, int e) const {
    if constexpr (kQuant) {
      return rt::to_f(k[u].v[e]) * ks[u];
    } else {
      return rt::to_f(k[u].v[e]);
    }
  }

  __device__ __forceinline__ float vval(int u, int e) const {
    if constexpr (kQuant) {
      return rt::to_f(v[u].v[e]) * vs[u];
    } else {
      return rt::to_f(v[u].v[e]);
    }
  }

  // Scores (base 2) of the loaded rows for the GM heads, then one
  // online-softmax update per head over the valid rows. Branch-free: the
  // rows past ``end`` enter with weight 0 (their registers hold zeros or an
  // earlier row, so every product is finite), and heads g >= G (zero query
  // rows) are computed and never stored. The softcap is applied before the
  // mask, as the TPU kernels do.
  __device__ __forceinline__ void step(const float (&qf)[GM][VEC], Softmax<GM, VEC>& s, int t,
                                       int sub, int end, float scale, float softcap) const {
    float kf[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[u][e] = kval(u, e);
    }
    float sc[kUnroll][GM];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d += qf[g][e] * kf[u][e];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[u][g] = d * scale;
      }
    }
    if (softcap != 0.f) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < GM; ++g) sc[u][g] = tanhf(sc[u][g] / softcap) * softcap;
      }
    }
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) valid[u] = t + u * RPW + sub < end;
    float vf[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[u][e] = vval(u, e);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s.m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sc[u][g] *= kLog2e;
        mx = valid[u] ? fmaxf(mx, sc[u][g]) : mx;
      }
      const float corr = rescale(s.m[g], mx);     // 0 while no row has been seen
      s.l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s.acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = valid[u] ? exp2f(sc[u][g] - mx) : 0.f;
        s.l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s.acc[g][e] += p * vf[u][e];
      }
      s.m[g] = mx;
    }
  }
};

// Walks rows [t_begin, end) with the warps of the block, two chunks in
// flight per warp, folding them into ``s``.
template <typename TS, int VEC, int LPR, int GM, typename Index>
__device__ __forceinline__ void walk(const float (&qf)[GM][VEC], Softmax<GM, VEC>& s,
                                     const TS* kb, const TS* vb, const __nv_bfloat16* ksb,
                                     const __nv_bfloat16* vsb, long long row_stride,
                                     const Index& index, int t_begin, int end, int warp, int sub,
                                     bool active, float scale, float softcap) {
  using Tl = Tile<TS, VEC, LPR, GM>;
  constexpr int stride = kWarps * Tl::CHUNK;
  Tl a, c;
  int t = t_begin + warp * Tl::CHUNK;
  a.load(kb, vb, ksb, vsb, row_stride, index, t, sub, end, active);
  for (; t < end; t += 2 * stride) {
    c.load(kb, vb, ksb, vsb, row_stride, index, t + stride, sub, end, active);
    a.step(qf, s, t, sub, end, scale, softcap);
    a.load(kb, vb, ksb, vsb, row_stride, index, t + 2 * stride, sub, end, active);
    c.step(qf, s, t + stride, sub, end, scale, softcap);
  }
}

template <int GM, int HD>
struct MergeSmem {
  float m[kWarps][GM], l[kWarps][GM];
  float acc[kWarps][GM][HD];
};

// Merges the lanes' states of the block and writes, for the hg.n heads of
// its group, either the output (one split: out, the G x hd of this (b, h))
// or this split's partial (pb: G maxima, G sums, G x hd accumulators, f32),
// each at head g0 + g.
template <typename TQ, int VEC, int LPR, int GM, int HD>
__device__ __forceinline__ void finish(Softmax<GM, VEC>& s, MergeSmem<GM, HD>& sm, int warp,
                                       int sub, int col, bool active, int G, const HeadGroup& hg,
                                       int hd, TQ* out, float* pb, int nsplit) {
  // merge the row groups of the warp (lanes col, col + LPR, ...)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, s.m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, s.l[g], o);
      const float M = fmaxf(s.m[g], mo);
      const float wa = rescale(s.m[g], M), wo = rescale(mo, M);
      s.l[g] = s.l[g] * wa + lo * wo;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s.acc[g][e] = s.acc[g][e] * wa + __shfl_xor_sync(0xffffffffu, s.acc[g][e], o) * wo;
      }
      s.m[g] = M;
    }
  }
  if (sub == 0 && active) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < hg.n) {
        if (col == 0) {
          sm.m[warp][g] = s.m[g];
          sm.l[warp][g] = s.l[g];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) sm.acc[warp][g][col * VEC + e] = s.acc[g][e];
      }
    }
  }
  __syncthreads();

  // merge the warps in warp order
  const int GH = hg.n * hd;
  for (int e = threadIdx.x; e < GH; e += kThreads) {
    const int g = e / hd, d = e % hd;
    float M = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm.m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = rescale(sm.m[w][g], M);
      num += sm.acc[w][g][d] * cw;
      den += sm.l[w][g] * cw;
    }
    if (nsplit == 1) {
      out[hg.g0 * hd + e] = rt::from_f<TQ>(num / fmaxf(den, 1e-30f));
    } else {
      pb[2 * G + hg.g0 * hd + e] = num;
      if (d == 0) {
        pb[hg.g0 + g] = M;
        pb[G + hg.g0 + g] = den;
      }
    }
  }
}

// Grid: B * KV blocks of kCombineThreads. Combines the nsplit partials of
// each (b, h) in split order: out = sum_s acc_s 2^(m_s - M) / sum_s l_s
// 2^(m_s - M), M = max m_s. Warp w reduces the maxima and sums of heads w,
// w + 8, ... across its lanes (a fixed tree: deterministic) and leaves the
// split weights in shared memory (nsplit G + G floats: the planners keep
// nsplit * n_groups <= 264, so at most 264 * 8 + G floats at G <= 8 and
// 264 * 4 + G past it); then each
// thread sums output elements e, e + 256, ... over the splits, its loads
// independent and unrolled.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ part, T* __restrict__ out, int G, int hd, int nsplit) {
  extern __shared__ float sm[];
  float* sm_w = sm;                      // [nsplit][G] weights
  float* sm_den = sm_w + nsplit * G;     // [G] sums
  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int GH = G * hd, PS = G * (hd + 2);
  const float* pb = part + static_cast<size_t>(bh) * nsplit * PS;
  for (int g = warp; g < G; g += kCombineThreads / 32) {
    float M = neg_inf();
    for (int sp = lane; sp < nsplit; sp += 32) M = fmaxf(M, pb[sp * PS + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float den = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const float c = rescale(pb[sp * PS + g], M);
      sm_w[sp * G + g] = c;
      den += pb[sp * PS + G + g] * c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    if (lane == 0) sm_den[g] = den;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GH; e += kCombineThreads) {
    const int g = e / hd;
    float num = 0.f;
#pragma unroll 16
    for (int sp = 0; sp < nsplit; ++sp) num += pb[sp * PS + 2 * G + e] * sm_w[sp * G + g];
    out[static_cast<size_t>(bh) * GH + e] = rt::from_f<T>(num / fmaxf(sm_den[g], 1e-30f));
  }
}

// Launches combine_kernel over n_bh (b, h) pairs after a split kernel.
template <typename T>
inline cudaError_t launch_combine(const float* part, T* out, int n_bh, int G, int hd, int nsplit,
                                  cudaStream_t s) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(nsplit) * G + G);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  combine_kernel<T><<<n_bh, kCombineThreads, smem, s>>>(part, out, G, hd, nsplit);
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace rt
