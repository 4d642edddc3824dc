// Fused GQA decode attention over a dense KV cache: one query token per
// sequence attends over the first cache_len[b] positions of its cache stripe.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py :: decode_attention_grouped
// (plus the softcap, which the TPU kernel drops and the jnp path applies:
// here it is applied before the mask, as in the paged kernel).
//
// Bound on the H100: memory bytes. The kernel reads each live K/V row once
// and does ~4 * G operations per element read (G = 3, or 16 for glm4-9b),
// far below the ~295 operations per byte at which compute would bind. At
// the serving path's
// sizes (a few hundred KB) what it costs is latency: how many loads are in
// flight at once, and how many dependent steps each block takes.
//
// Design (the warp-level machinery is decode_warp.cuh's, shared with the
// paged decode):
// - A block of four warps works on one (sequence b, KV head h, split of T).
//   Warps go across keys and lanes across hd: LPR lanes cover one cache row
//   with 16-byte loads (hd = 64: 8 lanes in bf16, 16 in f32; a row of
//   another width up to 32 elements takes a warp, one element a lane),
//   straight from device memory into registers, in the layout the cache is
//   stored in, (B, T, KV, hd), through its strides: no transposed or padded
//   copy, no staging in shared memory. Each warp keeps two chunks of rows
//   in flight.
// - The query rows, the online softmax (base 2) and the accumulators of a
//   head group live in registers; the group's width GM is a template width
//   (decode_warp.cuh's head groups: any G, in ceil(G / 4) groups of 4 heads
//   past G = 8, each group a block), so a chunk's heads and rows unroll
//   into independent chains without branches: at these sizes the kernel
//   waits on dependent arithmetic as much as on memory.
// - The T axis is split across blocks when B * KV * n_groups alone would
//   leave most of the 132 SMs idle (the wrapper's plan_splits: at most two
//   blocks per SM, so that all are resident at once, splits of at least 64
//   tokens; split s covers [s T / n, (s + 1) T / n)). Each split then
//   writes its (m, l, acc) in f32 to a scratch, and the shared combine
//   kernel merges the splits in split order: the output is deterministic,
//   with no float atomics. A split past its sequence's length writes m =
//   -inf and l = 0. With one split the block writes the output itself.
// A length of 0 yields 0, as the TPU kernel's finalize.
#include "decode_warp.cuh"

namespace {

using rt::dec::kThreads;

// Grid: B * KV * nsplit * n_groups blocks of kThreads (rt::dec::HeadGroup).
// q, out: (B, KV, G, hd) contiguous; k/v strided as stored. With nsplit > 1,
// ``part`` holds per (b, h, split) G maxima (base 2), G sums and G x hd
// accumulators, f32.
template <typename T, int VEC, int LPR, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part, int T_len, int KV, int G, int hd, int nsplit,
                    long long sb, long long st, long long sh, float scale, float softcap) {
  constexpr int HD = LPR * VEC;                    // the widest hd this instance takes
  using P = rt::Pack<T, VEC>;
  __shared__ rt::dec::MergeSmem<GM, HD> sm;

  const auto hg = rt::dec::HeadGroup::of<GM>(blockIdx.x, G, nsplit);
  const int split = hg.split, bh = hg.bh;
  const int b = bh / KV, h = bh % KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPR, col = lane % LPR;
  const bool active = col * VEC < hd;

  float qf[GM][VEC] = {};
  const T* qb = q + (static_cast<size_t>(bh) * G + hg.g0) * hd + col * VEC;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < hg.n && active) {
      const P pq = rt::dec::load_vec<P>(qb + g * hd);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][e] = rt::to_f(pq.v[e]);
    }
  }
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T_len ? T_len : len);
  const int t_begin = static_cast<int>(static_cast<long long>(split) * T_len / nsplit);
  const int t_stop = static_cast<int>(static_cast<long long>(split + 1) * T_len / nsplit);
  const int end = t_stop < len ? t_stop : len;

  rt::dec::Softmax<GM, VEC> s;
  s.init();
  const T* kb = k + b * sb + h * sh + col * VEC;
  const T* vb = v + b * sb + h * sh + col * VEC;
  rt::dec::walk<T, VEC, LPR, GM>(qf, s, kb, vb, nullptr, nullptr, st,
                                 [](int row) { return static_cast<long long>(row); }, t_begin,
                                 end, warp, sub, active, scale, softcap);
  float* pb = nsplit > 1
                  ? part + (static_cast<size_t>(bh) * nsplit + split) * (G * (hd + 2))
                  : nullptr;
  rt::dec::finish<T, VEC, LPR, GM, HD>(s, sm, warp, sub, col, active, G, hg, hd,
                                       out + static_cast<size_t>(bh) * G * hd, pb, nsplit);
}

template <typename T, int VEC, int LPR, int GM>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           float* part, int B, int T_len, int KV, int G, int hd, long long sb, long long st,
           long long sh, float scale, float softcap, int nsplit, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  const int n_groups = (G + GM - 1) / GM;
  decode_split_kernel<T, VEC, LPR, GM><<<B * KV * nsplit * n_groups, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths, o,
      part, T_len, KV, G, hd, nsplit, sb, st, sh, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && nsplit > 1) {
    err = rt::dec::launch_combine<T>(part, o, B * KV, G, hd, nsplit, s);
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
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 3) {  // smollm-360m's 15 query heads over 5 KV heads
    return dispatch_width<T, 3>(q, k, v, lengths, out, part, B, T_len, KV, G, hd, sb, st, sh,
                                scale, softcap, nsplit, s);
  }
  if (G <= 4 || G > 8) {  // past 8, groups of 4: glm4-9b's 32 heads over 2 are 4 a KV head
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
// (else unused). Any G >= 1; hd a multiple of 16 bytes' elements up to 32
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
