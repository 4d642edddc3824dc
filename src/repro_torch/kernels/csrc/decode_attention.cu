// Fused GQA decode attention over a dense KV cache: one query token per
// sequence attends over the first cache_len[b] positions of its cache stripe.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py :: decode_attention_grouped
// (plus the softcap, which the TPU kernel drops and the jnp path applies:
// here it is applied before the mask, as in the paged kernel).
//
// Bound on the H100: memory bytes. The kernel reads each live K/V row once
// and does ~4 * G operations per element read (G = 3), far below the ~295
// operations per byte at which compute would bind.
//
// Design: one block per (sequence b, KV head h) walks that sequence's cache
// in tiles of kTile tokens up to cache_len[b], with the online softmax of
// decode_tile.cuh for the G query heads; the loop replaces the TPU's
// sequential `it` grid axis and its VMEM scratch carry. The cache is read in
// the layout it is stored in, (B, T, KV, hd), through its strides: row t of
// head h is hd contiguous elements (128 bytes in bf16 at hd = 64), so each
// row is one coalesced load and no transposed or padded copy of the cache is
// made (the TPU wrapper transposes and pads the whole cache on every call).
// The last tile stops at cache_len[b]: positions past the length, and past
// T, are never read. A length of 0 yields 0, as the TPU kernel's finalize.
#include "decode_tile.cuh"

namespace {

constexpr int kTile = 32;

template <typename T>
__global__ void decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const int* __restrict__ lengths,
                                        T* __restrict__ out, int T_len, int KV, int G, int hd,
                                        long long sb, long long st, long long sh, float scale,
                                        float softcap) {
  extern __shared__ float sm[];
  const rt::DecodeSmem s = rt::decode_smem(sm, G, hd, kTile);
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int LDK = hd + 1;
  const int GH = G * hd;
  const T* qb = q + (static_cast<size_t>(b) * KV + h) * GH;
  for (int i = tid; i < GH; i += blockDim.x) s.q[i] = rt::to_f(qb[i]);

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T_len ? T_len : len);
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * sb + h * sh;
  rt::DecodeState state;
  state.init();
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = len - t0 < kTile ? len - t0 : kTile;
    for (int i = tid; i < n * hd; i += blockDim.x) {
      const int t = i / hd, d = i % hd;
      const long long off = (t0 + t) * st + d;
      s.k[t * LDK + d] = rt::to_f(kb[off]);
      s.v[i] = rt::to_f(vb[off]);
    }
    __syncthreads();
    rt::decode_tile(s, state, n, t0, len, G, hd, scale, softcap);
  }
  rt::decode_finalize(s, state, out + (static_cast<size_t>(b) * KV + h) * GH, G, hd);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* lengths, void* out, int B,
            int T_len, int KV, int G, int hd, long long sb, long long st, long long sh,
            float scale, float softcap, cudaStream_t s) {
  const size_t smem = rt::decode_smem_bytes(G, hd, kTile);
  decode_attention_kernel<T><<<B * KV, rt::kDecThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), T_len, KV, G, hd, sb, st, sh, scale, softcap);
}

}  // namespace

// q/out: (B, KV, G, hd) contiguous; k/v: (B, T, KV, hd) with element strides
// sb (batch), st (token) and sh (head) and unit stride over hd, both with
// the same strides; lengths: (B,) int32 valid positions per sequence.
extern "C" int rt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, int B, int T_len, int KV,
                                   int G, int hd, long long sb, long long st, long long sh,
                                   float scale, float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (B > 0) {
    if (dtype == rt::kBF16) {
      launch<__nv_bfloat16>(q, k, v, lens, out, B, T_len, KV, G, hd, sb, st, sh, scale, softcap, s);
    } else {
      launch<float>(q, k, v, lens, out, B, T_len, KV, G, hd, sb, st, sh, scale, softcap, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
