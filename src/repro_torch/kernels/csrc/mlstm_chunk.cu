// Chunkwise-parallel mLSTM forward with a carry: q, k, v (BH, S, DH) f32 or
// bf16 (q pre-scaled by 1/sqrt(DH)); i and lf = log_sigmoid(f) (BH, S) f32;
// the carry C0 (BH, DH, DH), n0 (BH, DH), m0 (BH) f32. Returns h (BH, S, DH)
// in q's dtype and the final C, n, m in f32. Chunks of L steps, S % L == 0.
// Per chunk, with cum the inclusive cumulative sum of lf inside the chunk:
//   D_ij  = (cum_i - cum_j) + i_j (j <= i),  m_i = max(max_j D_ij, cum_i + m0)
//   s_ij  = (q_i . k_j) exp(D_ij - m_i),     e_i = exp(cum_i + m0 - m_i)
//   h_i   = (s_i . v + e_i q_i C0) / max(|sum_j s_ij + e_i q_i . n0|, 1)
//   a_j   = (total - cum_j) + i_j,  m' = max(total + m0, max_j a_j)
//   C     = exp(total + m0 - m') C0 + sum_j exp(a_j - m') k_j v_j^T  (n alike)
//
// Replaces: src/repro/kernels/mlstm_chunk/kernel.py :: mlstm_chunkwise_bh,
// which always starts from zero state; this kernel takes the carry, so a
// chunked prefill resumes from it.
//
// Bound on the H100: at the serving path's shapes (DH = 512, L <= 96) the
// inter-chunk products q C and the carry update k^T v (2 L DH^2 FMAs each
// per chunk and head) dominate the operations, and reading and writing C
// (1 MiB per head in f32) dominates the bytes; at L = 8 the bytes bind, from
// L = 32 on the operations (f32, 67 TFLOP/s).
//
// Design: the TPU kernel keeps a head's whole C in VMEM for its chunk loop.
// On Hopper C at DH = 512 fits in no SM's shared memory, so C is split by
// columns: one block per (32-column tile of C, head), DH / 32 blocks a head,
// each holding its DH x 32 tile of C in shared memory for the whole chunk
// loop (64 KB at DH = 512), loaded from C0 once and stored once. Blocks carry
// nothing between them: every block of a head recomputes the chunk's gate
// scalars, the L x L scores, the denominators, n and m itself, with the
// same code in the same order, so they agree bit for bit, and block 0
// stores n and m. The L x L panel is tiled (16 query rows by 32 keys, keys
// staged in 128-wide slices of DH), so any L runs; the gate scalars (cum,
// the row stabilisers, the carry weights) live in a per-block global scratch
// of 3 L floats that the wrapper allocates. Tiles are staged into shared
// memory with 16-byte loads, four per thread in flight, and the products
// read shared memory 16 bytes at a time (4 FMAs per q or k read; the carry
// update keeps 4 rows of C in registers per lane), since shared-memory
// reads, not FMAs, bound this design. All arithmetic is f32 FMA in the
// plain version's order of terms (no tensor cores yet). exp(0) is exactly 1 and exp(-1e30 - m) exactly 0, so a
// chunk of pad steps (i = -1e30, lf = 0) leaves C, n and m bit-identical.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int TC = 32;          // columns of C per block (one per lane)
constexpr int RT = 16;          // query rows per tile (two per warp); carry steps per tile
constexpr int CT = 32;          // keys per tile of the L x L panel (one per lane)
constexpr int KD = 128;         // head-dim slice of a staged key tile
constexpr int KLD = KD + 4;     // padded key row: 16-byte reads by 8 lanes hit 32 banks
constexpr int SLD = CT + 1;     // padded score row
constexpr unsigned kFull = 0xffffffffu;

size_t smem_floats(int DH) {
  return static_cast<size_t>(DH) * TC   // Cs: this block's columns of C
         + DH                           // ns: n
         + static_cast<size_t>(RT) * DH // qs: q rows; k * w rows in the carry update
         + CT * KLD                     // ks: a key tile's DH slice
         + CT * TC                      // vs: v rows, this block's columns
         + RT * SLD                     // ss: decayed scores
         + 2 * RT                       // dsum, qn: per-row score sums and q . n
         + kThreads / 32 + 1;           // warp maxima, m'
}

// Rows [row0, row0 + nrows) of a row-major matrix with row stride DH,
// columns [col, col + ncols), into f32 shared memory dst[r * ld + c], times
// scale[row] when given; rows at or past rows_valid as zeros. VEC
// consecutive elements per load (ncols a multiple of VEC); U loads are in
// flight before any is stored, so their latencies overlap.
template <typename T, int VEC>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int DH, int row0,
                                      int nrows, int rows_valid, int col, int ncols,
                                      const float* scale) {
  using P = rt::Pack<T, VEC>;
  constexpr int U = 4;
  const int per_row = ncols / VEC;
  const int total = nrows * per_row;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * kThreads) {
    P p[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      const int row = row0 + e / per_row;
      live[u] = e < total && row < rows_valid;
      if (live[u]) {
        p[u] = *reinterpret_cast<const P*>(src + static_cast<size_t>(row) * DH + col +
                                           (e % per_row) * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= total) break;
      const int r = e / per_row;
      float* d = dst + r * ld + (e % per_row) * VEC;
      const float s = live[u] && scale ? scale[row0 + r] : 1.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        d[j] = !live[u] ? 0.f : scale ? rt::to_f(p[u].v[j]) * s : rt::to_f(p[u].v[j]);
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) mlstm_chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ lf, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0, T* __restrict__ h,
    float* __restrict__ Cout, float* __restrict__ nout, float* __restrict__ mout,
    float* scratch, int S, int DH, int L) {
  extern __shared__ float sm[];
  float* Cs = sm;
  float* ns = Cs + static_cast<size_t>(DH) * TC;
  float* qs = ns + DH;
  float* ks = qs + static_cast<size_t>(RT) * DH;
  float* vs = ks + CT * KLD;
  float* ss = vs + CT * TC;
  float* dsum = ss + RT * SLD;
  float* qn = dsum + RT;
  float* red = qn + RT;

  const int tile = blockIdx.x, bh = blockIdx.y;
  const int col0 = tile * TC;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t dd2 = static_cast<size_t>(DH) * DH;
  float* cum = scratch + (static_cast<size_t>(bh) * gridDim.x + tile) * 3 * L;
  float* mrow = cum + L;
  float* wts = mrow + L;

  constexpr int VT = kVec ? 16 / sizeof(T) : 1;   // elements of T per load
  constexpr int VF = kVec ? 4 : 1;                // f32 elements per load
  // Cs[d * TC + c] = C[d, col0 + c]
  stage<float, VF>(Cs, TC, C0 + bh * dd2, DH, 0, DH, DH, col0, TC, nullptr);
  for (int d = tid; d < DH; d += kThreads) ns[d] = n0[static_cast<size_t>(bh) * DH + d];
  float m_run = m0[bh];

  for (int c0 = 0; c0 < S; c0 += L) {
    const size_t row0 = static_cast<size_t>(bh) * S + c0;
    const float* ic = ig + row0;
    const float* lfc = lf + row0;
    const T* qc = q + row0 * DH;
    const T* kc = k + row0 * DH;
    const T* vc = v + row0 * DH;
    T* hc = h + row0 * DH;

    // 1. inclusive cumulative log-forget: warp 0, 32 steps at a time
    if (warp == 0) {
      float carry = 0.f;
      for (int t0 = 0; t0 < L; t0 += 32) {
        const int t = t0 + lane;
        float x = t < L ? lfc[t] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(kFull, x, o);
          if (lane >= o) x += y;
        }
        x += carry;
        if (t < L) cum[t] = x;
        carry = __shfl_sync(kFull, x, 31);
      }
    }
    __syncthreads();

    // 2. row stabilisers and the carry's new stabiliser m'
    const float total = cum[L - 1];
    float amax = -INFINITY;
    for (int r = tid; r < L; r += kThreads) {
      const float ci = cum[r];
      float dmax = -INFINITY;
#pragma unroll 4
      for (int j = 0; j <= r; ++j) dmax = fmaxf(dmax, (ci - cum[j]) + ic[j]);
      mrow[r] = fmaxf(dmax, ci + m_run);
      amax = fmaxf(amax, (total - ci) + ic[r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    if (tid == 0) {
      float mx = red[0];
      for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, red[w]);
      red[kThreads / 32] = fmaxf(total + m_run, mx);
    }
    __syncthreads();
    const float m_new = red[kThreads / 32];
    const float scale_old = expf((total + m_run) - m_new);

    // 3. carry weights
    for (int r = tid; r < L; r += kThreads) wts[r] = expf(((total - cum[r]) + ic[r]) - m_new);
    __syncthreads();

    // 4. h, RT query rows at a time, from C and n at the chunk start. Thread
    //    (warp, lane) holds rows warp and warp + 8 of the tile, key or
    //    column `lane`.
    const float* q0r = qs + warp * DH;
    const float* q1r = qs + (warp + 8) * DH;
    for (int r0 = 0; r0 < L; r0 += RT) {
      stage<T, VT>(qs, DH, qc, DH, r0, RT, L, 0, DH, nullptr);
      if (tid < RT) dsum[tid] = 0.f;
      __syncthreads();
      float num0 = 0.f, num1 = 0.f;
      const int jend = min(r0 + RT, L);
      for (int j0 = 0; j0 < jend; j0 += CT) {
        float s0 = 0.f, s1 = 0.f;
        for (int d0 = 0; d0 < DH; d0 += KD) {
          const int dn = min(KD, DH - d0);
          stage<T, VT>(ks, KLD, kc, DH, j0, CT, L, d0, dn, nullptr);
          __syncthreads();
          const float4* kr = reinterpret_cast<const float4*>(ks + lane * KLD);
          const float4* a4 = reinterpret_cast<const float4*>(q0r + d0);
          const float4* b4 = reinterpret_cast<const float4*>(q1r + d0);
          for (int d4 = 0; d4 < dn / 4; ++d4) {
            const float4 kv = kr[d4], a = a4[d4], b = b4[d4];
            s0 = fmaf(a.x, kv.x, s0);
            s0 = fmaf(a.y, kv.y, s0);
            s0 = fmaf(a.z, kv.z, s0);
            s0 = fmaf(a.w, kv.w, s0);
            s1 = fmaf(b.x, kv.x, s1);
            s1 = fmaf(b.y, kv.y, s1);
            s1 = fmaf(b.z, kv.z, s1);
            s1 = fmaf(b.w, kv.w, s1);
          }
          __syncthreads();
        }
        const int j = j0 + lane;
        const float dj = j < L ? ic[j] : 0.f;
        const float cj = j < L ? cum[j] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp + 8 * half, i = r0 + r;
          float s = 0.f;
          if (i < L && j <= i) s = (half ? s1 : s0) * expf(((cum[i] - cj) + dj) - mrow[i]);
          ss[r * SLD + lane] = s;
        }
        stage<T, VT>(vs, TC, vc, DH, j0, CT, L, col0, TC, nullptr);
        __syncthreads();
        for (int jj = 0; jj < CT; ++jj) {
          const float vv = vs[jj * TC + lane];
          num0 = fmaf(ss[warp * SLD + jj], vv, num0);
          num1 = fmaf(ss[(warp + 8) * SLD + jj], vv, num1);
        }
        if (tid < RT) {
          float acc = dsum[tid];
          for (int jj = 0; jj < CT; ++jj) acc += ss[tid * SLD + jj];
          dsum[tid] = acc;
        }
        __syncthreads();
      }
      // inter-chunk terms: q C[:, tile] and q . n
      float qc0 = 0.f, qc1 = 0.f;
      for (int d = 0; d < DH; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(q0r + d);
        const float4 b = *reinterpret_cast<const float4*>(q1r + d);
        const float c0 = Cs[d * TC + lane], c1 = Cs[(d + 1) * TC + lane];
        const float c2 = Cs[(d + 2) * TC + lane], c3 = Cs[(d + 3) * TC + lane];
        qc0 = fmaf(a.x, c0, qc0);
        qc0 = fmaf(a.y, c1, qc0);
        qc0 = fmaf(a.z, c2, qc0);
        qc0 = fmaf(a.w, c3, qc0);
        qc1 = fmaf(b.x, c0, qc1);
        qc1 = fmaf(b.y, c1, qc1);
        qc1 = fmaf(b.z, c2, qc1);
        qc1 = fmaf(b.w, c3, qc1);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* qr = half ? q1r : q0r;
        float acc = 0.f;
        for (int d = lane; d < DH; d += 32) acc = fmaf(qr[d], ns[d], acc);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
        if (lane == 0) qn[warp + 8 * half] = acc;
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp + 8 * half, i = r0 + r;
        if (i < L) {
          const float e = expf((cum[i] + m_run) - mrow[i]);
          const float num = (half ? num1 : num0) + e * (half ? qc1 : qc0);
          const float den = dsum[r] + e * qn[r];
          hc[static_cast<size_t>(i) * DH + col0 + lane] = rt::from_f<T>(num / fmaxf(fabsf(den), 1.f));
        }
      }
      __syncthreads();
    }

    // 5. carry update: C = scale_old C + sum_l (k_l w_l) v_l^T, n alike;
    //    warp w updates rows [w DH / 8, (w + 1) DH / 8) of Cs, 4 at a time
    //    in registers, column `lane`
    for (int idx = tid; idx < DH * TC; idx += kThreads) Cs[idx] *= scale_old;
    for (int d = tid; d < DH; d += kThreads) ns[d] *= scale_old;
    for (int l0 = 0; l0 < L; l0 += RT) {
      stage<T, VT>(qs, DH, kc, DH, l0, RT, L, 0, DH, wts);      // k_l w_l
      stage<T, VT>(vs, TC, vc, DH, l0, RT, L, col0, TC, nullptr);
      __syncthreads();
      const int ln = min(RT, L - l0);
      const int rows_per_warp = DH / (kThreads / 32);
      for (int d = warp * rows_per_warp; d < (warp + 1) * rows_per_warp; d += 4) {
        float a0 = Cs[d * TC + lane], a1 = Cs[(d + 1) * TC + lane];
        float a2 = Cs[(d + 2) * TC + lane], a3 = Cs[(d + 3) * TC + lane];
        for (int l = 0; l < ln; ++l) {
          const float4 kw = *reinterpret_cast<const float4*>(qs + l * DH + d);
          const float vv = vs[l * TC + lane];
          a0 = fmaf(kw.x, vv, a0);
          a1 = fmaf(kw.y, vv, a1);
          a2 = fmaf(kw.z, vv, a2);
          a3 = fmaf(kw.w, vv, a3);
        }
        Cs[d * TC + lane] = a0;
        Cs[(d + 1) * TC + lane] = a1;
        Cs[(d + 2) * TC + lane] = a2;
        Cs[(d + 3) * TC + lane] = a3;
      }
      for (int d = tid; d < DH; d += kThreads) {
        float acc = ns[d];
        for (int l = 0; l < ln; ++l) acc += qs[l * DH + d];
        ns[d] = acc;
      }
      __syncthreads();
    }
    m_run = m_new;
  }

  for (int idx = tid; idx < DH * TC; idx += kThreads) {
    Cout[bh * dd2 + static_cast<size_t>(idx / TC) * DH + col0 + idx % TC] = Cs[idx];
  }
  if (tile == 0) {
    for (int d = tid; d < DH; d += kThreads) nout[static_cast<size_t>(bh) * DH + d] = ns[d];
    if (tid == 0) mout[bh] = m_run;
  }
}

template <typename T, bool kVec>
cudaError_t launch_as(const void* q, const void* k, const void* v, const float* i,
                      const float* lf, const float* C0, const float* n0, const float* m0,
                      void* h, float* C, float* n, float* m, float* scratch, int BH, int S,
                      int DH, int L, cudaStream_t s) {
  const size_t smem = smem_floats(DH) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_kernel<T, kVec>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(DH / TC, BH);
  mlstm_chunk_kernel<T, kVec><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, lf, C0,
      n0, m0, static_cast<T*>(h), C, n, m, scratch, S, DH, L);
  return cudaSuccess;
}

// 16-byte loads need 16-byte aligned rows: DH is a multiple of 32, so the
// bases decide.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* i, const float* lf,
                   const float* C0, const float* n0, const float* m0, void* h, float* C,
                   float* n, float* m, float* scratch, int BH, int S, int DH, int L,
                   cudaStream_t s) {
  const bool vec = rt::aligned(q, 16) && rt::aligned(k, 16) && rt::aligned(v, 16) &&
                   rt::aligned(C0, 16);
  return vec ? launch_as<T, true>(q, k, v, i, lf, C0, n0, m0, h, C, n, m, scratch, BH, S, DH, L, s)
             : launch_as<T, false>(q, k, v, i, lf, C0, n0, m0, h, C, n, m, scratch, BH, S, DH, L,
                                   s);
}

}  // namespace

// q, k, v, h: (BH, S, DH); i, lf: (BH, S); C0, C: (BH, DH, DH); n0, n: (BH, DH);
// m0, m: (BH); scratch: BH * (DH / 32) * 3 * L floats; all contiguous.
// DH a multiple of 32 (up to 1024), 1 <= L, S % L == 0.
extern "C" int rt_mlstm_chunkwise(const void* q, const void* k, const void* v, const float* i,
                                  const float* lf, const float* C0, const float* n0,
                                  const float* m0, void* h, float* C, float* n, float* m,
                                  float* scratch, int BH, int S, int DH, int L, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH > 0 && S > 0 && L > 0 && S % L == 0 && DH % TC == 0 && DH > 0) {
    cudaError_t err =
        dtype == rt::kBF16
            ? launch<__nv_bfloat16>(q, k, v, i, lf, C0, n0, m0, h, C, n, m, scratch, BH, S, DH, L, s)
            : launch<float>(q, k, v, i, lf, C0, n0, m0, h, C, n, m, scratch, BH, S, DH, L, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
