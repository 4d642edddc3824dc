// Fused GQA decode attention over a dense KV cache: one query token per
// sequence attends over the first cache_len[b] positions of its cache stripe.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py :: decode_attention_grouped
// (plus the softcap, which the TPU kernel drops and the jnp path applies:
// here it is applied before the mask, as in the paged kernel).
//
// Bound on the H100: memory bytes. The kernel reads each live K/V row once
// and does ~4 * G operations per element read (G = 3), far below the ~295
// operations per byte at which compute would bind. At the serving path's
// sizes (a few hundred KB) what it costs is latency: how many loads are in
// flight at once, and how many dependent steps each block takes.
//
// Design:
// - Warps across keys, lanes across hd. A block of kWarps warps works on one
//   (sequence b, KV head h, split of T). LPR lanes cover one cache row with
//   16-byte loads (hd = 64: 8 lanes in bf16, 16 in f32; a row of another
//   width up to 32 elements takes a warp, one element a lane), so a warp
//   covers 32 / LPR rows per step, straight from device memory into
//   registers, in the layout the cache is stored in, (B, T, KV, hd), through
//   its strides: no transposed or padded copy, no staging in shared memory.
//   Each warp takes chunks of kUnroll * (32 / LPR) consecutive rows,
//   round-robin with the other warps, and loads the next chunk's K and V
//   before it computes on the current one, so several loads per lane are in
//   flight.
// - The G query rows live in registers (each lane its VEC columns). A dot
//   product is reduced with xor-shuffles among the LPR lanes of a row. Each
//   group of LPR lanes keeps its own online softmax (m, l) and accumulator
//   per query head, over the rows it reads, in registers, with scores in
//   base 2 (times log2 e) so that each exponential is one exp2f; rows past
//   the length are never read. The number of heads is a template width GM
//   (3, 4 or 8; heads past G run on zero query rows and are not stored), so
//   a chunk's heads and rows unroll into independent chains without
//   branches: at these sizes the kernel waits on dependent arithmetic as
//   much as on memory.
// - One merge at the end: the row groups of a warp by xor-shuffles, then the
//   warps through shared memory, in a fixed order.
// - The T axis is split across blocks when B * KV alone would leave most of
//   the 132 SMs idle (the wrapper's plan_splits: at most two blocks per SM,
//   so that all are resident at once, splits of at least 64 tokens; split s
//   covers [s T / n, (s + 1) T / n)).
//   Each split then writes its (m, l, acc) in f32 to a scratch, and a second
//   kernel combines the splits in split order: the output is deterministic,
//   with no float atomics. A split past its sequence's length writes
//   m = -inf and l = 0. With one split the block writes the output itself.
// A length of 0 yields 0, as the TPU kernel's finalize.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;  // row steps per chunk; two chunks' loads in flight
constexpr int kCombineThreads = 256;  // >= G * hd at hd = 64 for G <= 4: one element a thread

// One lane's vector of a row: a 16-byte load through the read-only path, or
// a narrower one on the general path.
template <typename P>
__device__ __forceinline__ P load_vec(const void* p) {
  if constexpr (sizeof(P) == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    P out;
    memcpy(&out, &r, sizeof(P));
    return out;
  } else {
    return *reinterpret_cast<const P*>(p);
  }
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// 2^(a - b) with 2^(-inf - anything) = 0, also when both are -inf. Scores
// are kept in base 2 (scaled by log2 e), so every exponential is one exp2f.
__device__ __forceinline__ float rescale(float a, float b) {
  return a == neg_inf() ? 0.f : exp2f(a - b);
}

// The online-softmax state of one lane: its VEC columns of G query heads,
// over the rows its group of LPR lanes has read.
template <int GM, int VEC>
struct Softmax {
  float m[GM], l[GM], acc[GM][VEC];
};

// A lane holds VEC consecutive elements of a row at column col * VEC; a row
// is LPR lanes (hd <= LPR * VEC; lanes past hd hold zeros).
template <typename T, int VEC, int LPR, int GM>
struct Tile {
  static constexpr int RPW = 32 / LPR;             // rows a warp covers per step
  static constexpr int CHUNK = kUnroll * RPW;      // rows per warp per chunk
  using P = rt::Pack<T, VEC>;

  P k[kUnroll] = {}, v[kUnroll] = {};

  // Rows t + u * RPW + sub (u < kUnroll) of this lane's column; rows at or
  // past ``end``, and columns past hd, are not read.
  __device__ __forceinline__ void load(const T* kb, const T* vb, long long st, int t, int sub,
                                       int end, bool active) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = t + u * RPW + sub;
      if (active && row < end) {
        k[u] = load_vec<P>(kb + row * st);
        v[u] = load_vec<P>(vb + row * st);
      }
    }
  }

  // Scores (base 2) of the loaded rows for the GM heads, then one
  // online-softmax update per head over the valid rows. Branch-free: the
  // rows past ``end`` enter with weight 0 (their registers hold zeros or an
  // earlier row, so every product is finite), and heads g >= G (zero query
  // rows) are computed and never stored, so the heads and rows of a chunk
  // are independent chains the scheduler can interleave.
  __device__ __forceinline__ void step(const float (&qf)[GM][VEC], Softmax<GM, VEC>& s, int t,
                                       int sub, int end, float scale, float softcap,
                                       float log2e) const {
    float sc[kUnroll][GM];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d += qf[g][e] * rt::to_f(k[u].v[e]);
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
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s.m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sc[u][g] *= log2e;
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
        for (int e = 0; e < VEC; ++e) s.acc[g][e] += p * rt::to_f(v[u].v[e]);
      }
      s.m[g] = mx;
    }
  }
};

// Grid: (B * KV) * nsplit blocks of kThreads. q, out: (B, KV, G, hd)
// contiguous; k/v strided as stored. With nsplit > 1, ``part`` holds per
// (b, h, split) G maxima (base 2), G sums and G x hd accumulators, f32.
template <typename T, int VEC, int LPR, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part, int T_len, int KV, int G, int hd, int nsplit,
                    long long sb, long long st, long long sh, float scale, float softcap) {
  using Tl = Tile<T, VEC, LPR, GM>;
  constexpr int HD = LPR * VEC;                    // the widest hd this instance takes
  using P = typename Tl::P;
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ float sm_m[kWarps][GM], sm_l[kWarps][GM];
  __shared__ float sm_acc[kWarps][GM][HD];

  const int split = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;
  const int b = bh / KV, h = bh % KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPR, col = lane % LPR;
  const bool active = col * VEC < hd;

  float qf[GM][VEC] = {};
  const T* qb = q + static_cast<size_t>(bh) * G * hd + col * VEC;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G && active) {
      const P pq = load_vec<P>(qb + g * hd);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][e] = rt::to_f(pq.v[e]);
    }
  }
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T_len ? T_len : len);
  const int t_begin = static_cast<int>(static_cast<long long>(split) * T_len / nsplit);
  const int t_stop = static_cast<int>(static_cast<long long>(split + 1) * T_len / nsplit);
  const int end = t_stop < len ? t_stop : len;

  Softmax<GM, VEC> s;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    s.m[g] = neg_inf();
    s.l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) s.acc[g][e] = 0.f;
  }

  const T* kb = k + b * sb + h * sh + col * VEC;
  const T* vb = v + b * sb + h * sh + col * VEC;
  constexpr int stride = kWarps * Tl::CHUNK;
  Tl a, c;
  int t = t_begin + warp * Tl::CHUNK;
  a.load(kb, vb, st, t, sub, end, active);
  for (; t < end; t += 2 * stride) {
    c.load(kb, vb, st, t + stride, sub, end, active);
    a.step(qf, s, t, sub, end, scale, softcap, kLog2e);
    a.load(kb, vb, st, t + 2 * stride, sub, end, active);
    c.step(qf, s, t + stride, sub, end, scale, softcap, kLog2e);
  }

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
      if (g < G) {
        if (col == 0) {
          sm_m[warp][g] = s.m[g];
          sm_l[warp][g] = s.l[g];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) sm_acc[warp][g][col * VEC + e] = s.acc[g][e];
      }
    }
  }
  __syncthreads();

  // merge the warps in warp order
  const int GH = G * hd;
  float* pb = nsplit > 1
                  ? part + (static_cast<size_t>(bh) * nsplit + split) * (G * (hd + 2))
                  : nullptr;
  for (int e = threadIdx.x; e < GH; e += kThreads) {
    const int g = e / hd, d = e % hd;
    float M = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = rescale(sm_m[w][g], M);
      num += sm_acc[w][g][d] * cw;
      den += sm_l[w][g] * cw;
    }
    if (nsplit == 1) {
      out[static_cast<size_t>(bh) * GH + e] = rt::from_f<T>(num / fmaxf(den, 1e-30f));
    } else {
      pb[2 * G + e] = num;
      if (d == 0) {
        pb[g] = M;
        pb[G + g] = den;
      }
    }
  }
}

// Grid: B * KV blocks of kCombineThreads. Combines the nsplit partials of
// each (b, h) in split order: out = sum_s acc_s 2^(m_s - M) / sum_s l_s
// 2^(m_s - M), M = max m_s. Warp g reduces head g's maxima and sums across
// its lanes (a fixed tree: deterministic) and leaves the split weights in
// shared memory (nsplit G + G floats); then each thread sums one output
// element over the splits, its loads independent and unrolled.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int G, int hd,
                      int nsplit) {
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

template <typename T, int VEC, int LPR, int GM>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           float* part, int B, int T_len, int KV, int G, int hd, long long sb, long long st,
           long long sh, float scale, float softcap, int nsplit, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  decode_split_kernel<T, VEC, LPR, GM><<<B * KV * nsplit, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths, o,
      part, T_len, KV, G, hd, nsplit, sb, st, sh, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && nsplit > 1) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(nsplit) * G + G);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    decode_combine_kernel<T><<<B * KV, kCombineThreads, smem, s>>>(part, o, G, hd, nsplit);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// The fast path (16-byte vectors, 8, 16 or 32 lanes a row) where hd is a
// multiple of a vector, at most 32 of them, and q, k, v and the strides are
// 16-byte aligned; else the general path (one element a lane, a warp a
// row) for hd <= 32.
template <typename T, int GM>
int dispatch_width(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   float* part, int B, int T_len, int KV, int G, int hd, long long sb,
                   long long st, long long sh, float scale, float softcap, int nsplit,
                   cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const bool fast = hd % V16 == 0 && hd <= 32 * V16 && rt::aligned(q, 16) &&
                    rt::aligned(k, 16) && rt::aligned(v, 16) && sb % V16 == 0 &&
                    st % V16 == 0 && sh % V16 == 0;
#define RT_DECODE_LAUNCH(VEC, LPR)                                                          \
  return launch<T, VEC, LPR, GM>(q, k, v, lengths, out, part, B, T_len, KV, G, hd, sb, st, sh, \
                                 scale, softcap, nsplit, s)
  if (fast && hd <= 8 * V16) RT_DECODE_LAUNCH(V16, 8);
  if (fast && hd <= 16 * V16) RT_DECODE_LAUNCH(V16, 16);
  if (fast) RT_DECODE_LAUNCH(V16, 32);
  if (hd <= 32) RT_DECODE_LAUNCH(1, 32);
#undef RT_DECODE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lengths, void* out,
             float* part, int B, int T_len, int KV, int G, int hd, long long sb, long long st,
             long long sh, float scale, float softcap, int nsplit, cudaStream_t s) {
  if (G < 1 || G > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 3) {  // smollm-360m's 15 query heads over 5 KV heads
    return dispatch_width<T, 3>(q, k, v, lengths, out, part, B, T_len, KV, G, hd, sb, st, sh,
                                scale, softcap, nsplit, s);
  }
  if (G <= 4) {
    return dispatch_width<T, 4>(q, k, v, lengths, out, part, B, T_len, KV, G, hd, sb, st, sh,
                                scale, softcap, nsplit, s);
  }
  return dispatch_width<T, 8>(q, k, v, lengths, out, part, B, T_len, KV, G, hd, sb, st, sh,
                              scale, softcap, nsplit, s);
}

}  // namespace

// q/out: (B, KV, G, hd) contiguous; k/v: (B, T, KV, hd) with element strides
// sb (batch), st (token) and sh (head) and unit stride over hd, both with
// the same strides; lengths: (B,) int32 valid positions per sequence;
// part: with nsplit > 1, B * KV * nsplit * G * (hd + 2) f32 of scratch
// (else unused). G at most 8; hd a multiple of 16 bytes' elements up to 32
// vectors with 16-byte aligned q, k, v and strides, else hd <= 32.
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, void* part, int B, int T_len,
                                   int KV, int G, int hd, long long sb, long long st, long long sh,
                                   float scale, float softcap, int nsplit, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* p = static_cast<float*>(part);
  if (B <= 0 || KV <= 0) return static_cast<int>(cudaGetLastError());
  if (nsplit < 1 || (nsplit > 1 && p == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::kBF16) {
    return dispatch<__nv_bfloat16>(q, k, v, lens, out, p, B, T_len, KV, G, hd, sb, st, sh, scale,
                                   softcap, nsplit, s);
  }
  return dispatch<float>(q, k, v, lens, out, p, B, T_len, KV, G, hd, sb, st, sh, scale, softcap,
                         nsplit, s);
}
