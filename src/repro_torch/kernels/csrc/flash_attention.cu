// Causal GQA flash attention, forward: q (B, S, H, hd), k/v (B, S, KV, hd),
// o (B, S, H, hd), each read or written through its own element strides (the
// last dimension contiguous), so the model's layout and the (B, H, S, hd)
// layout are both taken as they lie; the KV head of query head h is
// h / (H / KV); f32 softmax, output in q's dtype.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py :: flash_attention_bhsd
// (no softcap and no position offsets, like the TPU kernel).
//
// Bound on the H100: at the serving path's prompt lengths (S <= 96, hd = 64)
// the work is a few hundred KB and about a MFLOP a head, so latency binds:
// how few blocks and dependent steps a call takes. At long S the products
// bind, 4 S^2 hd H / 2 operations, which only the tensor cores carry at
// the card's rate.
//
// Design (bf16, the serving path):
// - A block's rows are (position s, head g) pairs of one KV head, s major:
//   the G query heads of a KV head lie next to each other in H, so a row
//   tile is 64 / G positions x G heads, and each K/V tile is loaded once for
//   all G heads. At S = 16, G = 3 one block holds all 48 rows. Four warps
//   own 16 rows each.
// - Q K^T and P V run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), their fragments loaded by ldmatrix (.trans for V).
//   Scores, the running (m, l) and the output accumulators stay in
//   registers; each row's max and sum are reduced over its quad of lanes
//   with xor-shuffles; p = 2^(s scale log2 e - m scale log2 e) is one FFMA
//   and one ex2 on the special-function unit; P is rounded to bf16 in
//   registers for the P V product, as FlashAttention-2 does, and l sums the
//   f32 probabilities.
// - K/V tiles of 64 keys arrive by cp.async, 16 bytes a copy, each thread
//   one fixed column chunk, into shared rows of HDMAX (64 or 128) columns
//   padded by 16 bytes, so that ldmatrix's eight row addresses fall in
//   distinct banks; two stages, so the next tile is in flight while the
//   current one is computed. Columns past hd are zero-filled (any hd <=
//   128), so every loop runs to a compile-time bound without a branch.
//   Rows with hd not a multiple of 8 or unaligned strides take plain loads
//   into the same layout.
// - Causal skipping: a block walks only the kv tiles up to its last row's
//   position and loads only their keys up to it (in 16-key steps); a warp
//   skips the tiles past its own last row and the 16-key steps of a tile
//   past it, and masks (by select, no branch per element) only the tiles
//   that reach past its first row or past S. A ragged S is masked in place
//   (rows past S * G are never stored, keys past S load as zeros and are
//   masked): no padded copy.
// At long S what bounds it on this card is each warp's own traffic: a
// 16-row warp re-reads every K/V fragment from shared memory, beside one
// ex2 per score and the softmax's instructions, where a 64-row warpgroup
// product (wgmma) would read it once.
// f32 runs on the CUDA cores in exact f32 FMAs (bf16 or TF32 products would
// miss the f32 parity tolerance; only the parity runs use f32): the same
// row packing and per-warp register state, a lane per (row, half of the
// keys and columns), K/V tiles of 32 keys in shared memory, and no
// shared-memory score matrix.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // (position, head) rows per block
constexpr int kBkv = 64;            // keys per tile, bf16
constexpr int kBkvF = 32;           // keys per tile, f32
constexpr int kMaxHd = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides of a (B, S, heads, hd) view; hd is contiguous
};

struct FlashArgs {
  const void *q, *k, *v;
  void* o;
  Strides sq, sk, sv, so;
  int B, H, KV, S, hd;
  float scale;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// 2^x on the special-function unit (2 ulp; a result below 2^-126 flushes to
// 0, as a probability that small adds nothing to a row's sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [0, n) of a tile into shared memory: HDMAX columns a row at a row
// stride of HDMAX + 8 elements, zeros past hd and for rows where rowp(r)
// is null. With ``vec`` (hd a multiple of 8, 16-byte aligned rows) each
// thread copies one fixed 16-byte column chunk of every kThreads / (HDMAX /
// 8)-th row by cp.async; else plain loads.
template <int HDMAX, typename RowPtr>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int n, int hd, bool vec,
                                          const RowPtr& rowp, const __nv_bfloat16* any) {
  constexpr int LD = HDMAX + 8, kCpr = HDMAX / 8, kRpp = kThreads / kCpr;
  if (vec) {
    const int c = threadIdx.x % kCpr;
    const bool col_in = c * 8 < hd;
    for (int r = threadIdx.x / kCpr; r < n; r += kRpp) {
      const __nv_bfloat16* p = rowp(r);
      const bool in = col_in && p != nullptr;
      cp_async16(smem_u32(dst + r * LD + c * 8), in ? p + c * 8 : any, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * HDMAX; i += kThreads) {
      const int r = i / HDMAX, d = i % HDMAX;
      const __nv_bfloat16* p = rowp(r);
      dst[r * LD + d] = p != nullptr && d < hd ? p[d] : __float2bfloat16(0.f);
    }
  }
}

template <int HDMAX>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(const FlashArgs a, const bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using bf16 = __nv_bfloat16;
  constexpr int LD = HDMAX + 8;  // 16 bytes of padding: ldmatrix rows in distinct banks
  const int hd = a.hd, S = a.S;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kRows * LD;       // two stages of kBkv rows
  bf16* sV = sK + 2 * kBkv * LD;    // two stages of kBkv rows

  const int G = a.H / a.KV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int R0 = blockIdx.x * kRows;
  const int n_rows = S * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + static_cast<long long>(kvh) * G * a.sq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  const int p_last = (min(R0 + kRows, n_rows) - 1) / G;  // the block's last position
  const int n_tiles = p_last / kBkv + 1;
  // keys the block's warps read: up to its last position or S, in whole
  // 16-key steps (keys past S zero-filled, the rest of a tile not loaded)
  const int key_end = min(S, p_last + 1);
  auto kv_tile = [&](int t0, int stage) {
    const int n = min(kBkv, (key_end - t0 + 15) & ~15);
    const bf16* kt = kb + t0 * a.sk.s;
    const bf16* vt = vb + t0 * a.sv.s;
    const int left = S - t0;
    load_tile<HDMAX>(sK + stage * kBkv * LD, n, hd, vec,
                     [&](int r) { return r < left ? kt + r * a.sk.s : nullptr; }, kb);
    load_tile<HDMAX>(sV + stage * kBkv * LD, n, hd, vec,
                     [&](int r) { return r < left ? vt + r * a.sv.s : nullptr; }, vb);
  };
  load_tile<HDMAX>(sQ, kRows, hd, vec, [&](int r) -> const bf16* {
    const int R = R0 + r;
    return R < n_rows ? qb + (R / G) * a.sq.s + (R % G) * a.sq.h : nullptr;
  }, qb);
  kv_tile(0, 0);
  cp_async_commit();

  const int wr0 = R0 + warp * 16;  // the warp's first row
  const bool live = wr0 < n_rows;
  const int w_pmin = wr0 / G;
  const int w_pmax = (min(wr0 + 16, n_rows) - 1) / G;
  // this lane's rows are lane / 4 and lane / 4 + 8 of the warp's: the last
  // key each may see (its position, at most S - 1)
  const int lim_lo = min((wr0 + (lane >> 2)) / G, S - 1);
  const int lim_hi = min((wr0 + (lane >> 2) + 8) / G, S - 1);
  const float sl2 = a.scale * kLog2e;

  unsigned qa[HDMAX / 16][4];
  float acc[HDMAX / 8][4];
#pragma unroll
  for (int j = 0; j < HDMAX / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = neg_inf(), m_hi = neg_inf(), l_lo = 0.f, l_hi = 0.f;  // raw-score maxima

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      kv_tile((it + 1) * kBkv, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0 && live) {  // Q arrived with the first tile
#pragma unroll
      for (int kk = 0; kk < HDMAX / 16; ++kk) {
        ldsm_x4(smem_u32(sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8),
                qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
      }
    }
    const int t0 = it * kBkv;
    if (live && t0 <= w_pmax) {
      const bf16* ks = sK + stage * kBkv * LD;
      const bf16* vs = sV + stage * kBkv * LD;
      // keys this warp's rows can see, in whole 16-key steps: the steps past
      // them are skipped (a tile short of that is always masked below)
      const int kw = min(kBkv, (min(S, w_pmax + 1) - t0 + 15) & ~15);
      float sc[kBkv / 8][4];
#pragma unroll
      for (int jp = 0; jp < kBkv / 16; ++jp) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[2 * jp][c] = sc[2 * jp + 1][c] = 0.f;
        if (jp * 16 < kw) {
#pragma unroll
          for (int kk = 0; kk < HDMAX / 16; ++kk) {
            unsigned b0, b1, b2, b3;
            ldsm_x4(smem_u32(ks + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8),
                    b0, b1, b2, b3);
            mma_bf16(sc[2 * jp], qa[kk], b0, b1);
            mma_bf16(sc[2 * jp + 1], qa[kk], b2, b3);
          }
        }
      }
      if (t0 + kBkv - 1 > w_pmin || t0 + kBkv > S) {  // the diagonal or the ragged end
        const int rl = lim_lo - t0, rh = lim_hi - t0;
#pragma unroll
        for (int j = 0; j < kBkv / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = j * 8 + (lane & 3) * 2 + (c & 1);
            sc[j][c] = key > (c < 2 ? rl : rh) ? neg_inf() : sc[j][c];
          }
        }
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < kBkv / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[j][0], sc[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
      }
      // p = 2^((s - max) scale log2 e), one FFMA and one ex2 each
      const float ms_lo = (mx_lo == neg_inf() ? 0.f : mx_lo) * sl2;
      const float ms_hi = (mx_hi == neg_inf() ? 0.f : mx_hi) * sl2;
      const float c_lo = ex2(fmaf(m_lo, sl2, -ms_lo)), c_hi = ex2(fmaf(m_hi, sl2, -ms_hi));
      m_lo = mx_lo;
      m_hi = mx_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < kBkv / 8; ++j) {
        sc[j][0] = ex2(fmaf(sc[j][0], sl2, -ms_lo));
        sc[j][1] = ex2(fmaf(sc[j][1], sl2, -ms_lo));
        sc[j][2] = ex2(fmaf(sc[j][2], sl2, -ms_hi));
        sc[j][3] = ex2(fmaf(sc[j][3], sl2, -ms_hi));
        sum_lo += sc[j][0] + sc[j][1];
        sum_hi += sc[j][2] + sc[j][3];
      }
      l_lo = l_lo * c_lo + sum_lo;
      l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < HDMAX / 8; ++j) {
        acc[j][0] *= c_lo;
        acc[j][1] *= c_lo;
        acc[j][2] *= c_hi;
        acc[j][3] *= c_hi;
      }
#pragma unroll
      for (int kk = 0; kk < kBkv / 16; ++kk) {
        if (kk * 16 < kw) {
          const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                  pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                  pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                  pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
          for (int j = 0; j < HDMAX / 8; j += 2) {
            unsigned b0, b1, b2, b3;
            ldsm_x4_t(smem_u32(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 8 +
                               (lane >> 4) * 8),
                      b0, b1, b2, b3);
            mma_bf16(acc[j], pa, b0, b1);
            mma_bf16(acc[j + 1], pa, b2, b3);
          }
        }
      }
    }
    __syncthreads();  // the stage read here is the next iteration's load target
  }

  if (!live) return;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  bf16* ob = static_cast<bf16*>(a.o) + b * a.so.b + static_cast<long long>(kvh) * G * a.so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = wr0 + (lane >> 2) + half * 8;
    if (R < n_rows) {
      const float inv = 1.f / fmaxf(half ? l_hi : l_lo, 1e-30f);
      bf16* orow = ob + (R / G) * a.so.s + (R % G) * a.so.h;
#pragma unroll
      for (int j = 0; j < HDMAX / 8; ++j) {
        const int d = j * 8 + (lane & 3) * 2;
        if (d < hd) orow[d] = __float2bfloat16(acc[j][2 * half] * inv);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16(acc[j][2 * half + 1] * inv);
      }
    }
  }
}

// f32 (parity runs): lane (r, h) = (lane % 16, lane / 16) keeps row r of its
// warp's 16, keys 2j + h of each 32-key tile and output columns 2i + h.
template <int HDMAX>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const FlashArgs a) {
  extern __shared__ float smf[];
  const int hd = a.hd, S = a.S;
  const int LQ = hd + 1, LK = hd + 1;  // odd strides: the 16 rows of a warp in distinct banks
  float* sQ = smf;                     // kRows x LQ
  float* sK = sQ + kRows * LQ;         // kBkvF x LK
  float* sV = sK + kBkvF * LK;         // kBkvF x HDMAX, zeros past hd

  const int G = a.H / a.KV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int R0 = blockIdx.x * kRows;
  const int n_rows = S * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, h = lane >> 4;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + static_cast<long long>(kvh) * G * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int rr = i / hd, d = i % hd, R = R0 + rr;
    sQ[rr * LQ + d] = R < n_rows ? qb[(R / G) * a.sq.s + (R % G) * a.sq.h + d] : 0.f;
  }
  const int p_last = (min(R0 + kRows, n_rows) - 1) / G;
  const int n_tiles = p_last / kBkvF + 1;
  const int wr0 = R0 + warp * 16;
  const bool live = wr0 < n_rows;
  const int w_pmin = wr0 / G;
  const int w_pmax = (min(wr0 + 16, n_rows) - 1) / G;
  const int pos = (wr0 + r) / G;
  const float sl2 = a.scale * kLog2e;
  const float* qrow = sQ + (warp * 16 + r) * LQ;

  float acc[HDMAX / 2];
#pragma unroll
  for (int i = 0; i < HDMAX / 2; ++i) acc[i] = 0.f;
  float m = neg_inf(), l = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kBkvF;
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < kBkvF * HDMAX; i += kThreads) {
      const int t = i / HDMAX, d = i % HDMAX;
      const bool in = t0 + t < S && d < hd;
      if (d < hd) sK[t * LK + d] = in ? kb[(t0 + t) * a.sk.s + d] : 0.f;
      sV[i] = in ? vb[(t0 + t) * a.sv.s + d] : 0.f;
    }
    __syncthreads();
    if (!live || t0 > w_pmax) continue;
    float s[kBkvF / 2];
#pragma unroll
    for (int j = 0; j < kBkvF / 2; ++j) s[j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kBkvF / 2; ++j) s[j] = fmaf(qd, sK[(2 * j + h) * LK + d], s[j]);
    }
    const bool mask = t0 + kBkvF - 1 > w_pmin || t0 + kBkvF > S;
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBkvF / 2; ++j) {
      const int key = t0 + 2 * j + h;
      s[j] = mask && (key > pos || key >= S) ? neg_inf() : s[j] * sl2;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float mu = mx == neg_inf() ? 0.f : mx;
    const float corr = exp2f(m - mu);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBkvF / 2; ++j) {
      s[j] = exp2f(s[j] - mu);
      sum += s[j];
    }
    l = l * corr + sum;
#pragma unroll
    for (int i = 0; i < HDMAX / 2; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBkvF / 2; ++j) {
      const float po = s[j];
      const float px = __shfl_xor_sync(0xffffffffu, s[j], 16);  // key 2j + 1 - h
      const float* v_own = sV + (2 * j + h) * HDMAX + h;
      const float* v_other = sV + (2 * j + 1 - h) * HDMAX + h;
#pragma unroll
      for (int i = 0; i < HDMAX / 2; ++i) {
        acc[i] = fmaf(po, v_own[2 * i], acc[i]);
        acc[i] = fmaf(px, v_other[2 * i], acc[i]);
      }
    }
  }

  if (!live) return;
  l += __shfl_xor_sync(0xffffffffu, l, 16);
  const int R = wr0 + r;
  if (R >= n_rows) return;
  float* orow = static_cast<float*>(a.o) + b * a.so.b + (R / G) * a.so.s +
                static_cast<long long>(kvh * G + R % G) * a.so.h;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < HDMAX / 2; ++i) {
    if (2 * i + h < hd) orow[2 * i + h] = acc[i] * inv;
  }
}

// Opts a kernel into more than 48 KB of dynamic shared memory where it needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

dim3 grid_of(const FlashArgs& a) {
  return dim3((a.S * (a.H / a.KV) + kRows - 1) / kRows, a.KV, a.B);
}

template <int HDMAX>
cudaError_t launch_bf16(const FlashArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(__nv_bfloat16) * static_cast<size_t>(kRows + 4 * kBkv) * (HDMAX + 8);
  const bool vec = a.hd % 8 == 0 && rt::aligned(a.q, 16) && rt::aligned(a.k, 16) &&
                   rt::aligned(a.v, 16) && a.sq.b % 8 == 0 && a.sq.s % 8 == 0 &&
                   a.sq.h % 8 == 0 && a.sk.b % 8 == 0 && a.sk.s % 8 == 0 && a.sk.h % 8 == 0 &&
                   a.sv.b % 8 == 0 && a.sv.s % 8 == 0 && a.sv.h % 8 == 0;
  cudaError_t err = allow_smem(flash_bf16_kernel<HDMAX>, smem);
  if (err != cudaSuccess) return err;
  flash_bf16_kernel<HDMAX><<<grid_of(a), kThreads, smem, s>>>(a, vec);
  return cudaGetLastError();
}

template <int HDMAX>
cudaError_t launch_f32(const FlashArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kRows + kBkvF) * (a.hd + 1) +
                                       static_cast<size_t>(kBkvF) * HDMAX);
  cudaError_t err = allow_smem(flash_f32_kernel<HDMAX>, smem);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<HDMAX><<<grid_of(a), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q/o: (B, S, H, hd) and k/v: (B, S, KV, hd), each given by its element
// strides over (B, S, heads) with hd contiguous (the (B, H, S, hd) layout
// passes its own strides); f32 or bf16 (dtype); H a multiple of KV; hd <= 128.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int KV, int S, int hd, long long qsb, long long qss,
                                  long long qsh, long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh, long long osb,
                                  long long oss, long long osh, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxHd) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FlashArgs a{q, k, v, o, {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                    {osb, oss, osh}, B, H, KV, S, hd, scale};
  cudaError_t err;
  if (dtype == rt::kBF16) {
    err = hd <= 64 ? launch_bf16<64>(a, s) : launch_bf16<128>(a, s);
  } else {
    err = hd <= 64 ? launch_f32<64>(a, s) : launch_f32<128>(a, s);
  }
  return static_cast<int>(err);
}
