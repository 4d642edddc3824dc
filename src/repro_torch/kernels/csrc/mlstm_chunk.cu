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
// L = 32 on the operations at the f32 rate (67 TFLOP/s). At the bf16
// instance's own rates (q k^T and s v at 989 TFLOP/s, q C in TF32 at 495,
// the update in f32) the bytes bind up to L = 32, the operations from 96.
//
// Both instances split C by columns: C at DH = 512 fits in no SM's shared
// memory, so one block per (column tile of C, head) holds its DH x TC tile
// of C in shared memory for the whole chunk loop. Blocks carry nothing
// between them: every block of a head computes the chunk's gate scalars,
// the L x L scores, the denominators, n and m itself, with the same code in
// the same order, so they agree bit for bit, and block 0 stores n and m.
// exp(0) is exactly 1 and exp(-1e30 - m) exactly 0, so a chunk of pad steps
// (i = -1e30, lf = 0) leaves C, n and m bit-identical.
//
// bf16 (the serving path), namespace tc, on the tensor cores:
// - TC is 16 or 32 columns (the wrapper's plan_col_tile: 16 where DH / 32
//   blocks a head would leave SMs idle), so BH 4 at DH 512 runs 128 blocks.
// - C0's tile and n0 arrive by 16-byte cp.async, all issued at the start as
//   the first copy group; the gate scalars are computed while they fly (the
//   first chunk's gates are loaded before the copies are issued). The final
//   C is stored from registers, 16 bytes a store.
// - Gate scalars live in shared memory, computed by all warps: cum is a warp
//   scan per 32 steps plus the sum of the earlier segments' totals (the
//   same additions in the same order as one running scan); the row
//   stabiliser is a prefix maximum, m_i = max(cum_i + max_{j<=i}(i_j -
//   cum_j), cum_i + m0), O(L) in all, kept as A_i = cum_i - m_i beside B_j
//   = i_j - cum_j (it feeds only h); m', exp(total + m0 - m') and the carry
//   weights keep the plain version's expressions.
// - q k^T: q and k stay bf16 in padded shared rows (16 bytes of padding, so
//   ldmatrix's eight row addresses fall in distinct banks), in DH slices by
//   cp.async, double-buffered; the slices of all (query group, key group)
//   pairs of a chunk form one pipeline, so the next pair's first slice is
//   in flight while the current pair finishes, and the last slice step
//   prefetches the carry update's first tile. 64-row groups; a slice is as
//   wide as a stage holds for the staged rows (512 for 16 rows, 128 for 64
//   where shared memory allows, else half). mma.sync m16n8k16 (bf16 in, f32
//   accumulate, two chains over even and odd 16-steps), fragments by
//   ldmatrix; each warp owns up to two 16 x 16 blocks of the causal 64 x 64
//   panel. The causal mask (by select) and the decay exp(A_i + B_j) are
//   applied in registers; the scores go to shared memory rounded to bf16
//   (as s v takes them, as flash rounds P), their unrounded f32 row sums
//   beside them, summed in a fixed order for the denominators.
// - s v: mma.sync m16n8k16, s by ldmatrix, v's columns by ldmatrix.trans.
//   q C: TF32 mma.sync m16n8k8, A the bf16 q fragments widened (exact in
//   TF32), B the f32 C tile in shared rows padded to TC + 4 floats (the
//   fragment reads fall in distinct banks); the k index inside each 8-step
//   is permuted so that the bf16 fragment registers serve as TF32 ones.
//   A warp pair owns h's 16 rows x TC columns of a group's 16-row tile;
//   where a group has fewer than four live tiles, the idle pairs take a
//   share of q C's 16-steps and leave partial sums in shared memory, added
//   in a fixed order. Both products feed only h (bf16 tolerance 2e-2);
//   q . n is an f32 dot product, 4 to 16 lanes a row, reduced by shuffles.
// - The carry update stays exact f32 FMA in the plain version's order
//   (scale by exp(total + m0 - m') first, then the steps in order), with C
//   in registers: each thread holds 8 rows x 4 columns of C for a pass of
//   8192 elements (one pass at DH 512, TC 16), and reads a step's 8 k, 4 v
//   and w from shared memory once for its 32 FMAs; C is written back to
//   shared memory once per chunk, for the next chunk's q C.
// - L is bounded only by shared memory: the gate scalars take 24 L bytes
//   (L up to 5348 at DH 512 and TC 16, 536 at DH 1024 and TC 32); past it the
//   launch returns cudaErrorInvalidValue.
// What bounds it now (clock-stamped builds on the H100): the first chunk
// waits for C0 and its q/k rows, as every block of a head stages the same q
// and k slices; then the q C share of each slice step and the update's
// shared-memory reads, at one block (8 warps) per SM.
// f32 (the parity runs), mlstm_chunk_kernel<float>: exact f32 FMAs in the
// plain version's order of terms, no tensor cores (TF32 or bf16 products
// would miss the f32 tolerance): 32 columns a block, the L x L panel tiled
// 16 query rows by 32 keys with keys staged in 128-wide slices of DH, the
// gate scalars in a per-block global scratch of 3 L floats that the wrapper
// allocates, tiles staged with 16-byte loads (four in flight a thread) and
// read from shared memory 16 bytes at a time.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

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
// bases decide. Instantiated for f32 only.
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

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;    // 8 warps
constexpr int QB = 64;           // query rows of a group and keys of a key group (4 x 16)
constexpr int kStageBig = QB * 136;   // bf16 elements of a q or k slice buffer: 64 x 128 wide
constexpr int kStageSmall = QB * 72;  // 64 x 64 wide, where the big one does not fit
constexpr int SLD = QB + 8;      // padded bf16 score row: ldmatrix rows in distinct banks
constexpr int LT = 16;           // carry-update steps per staged tile
constexpr int kUpd = 8192;       // C elements one update pass holds in registers (256 x 8 x 4)
constexpr int kMaxSmem = 232448; // shared memory a block may use on the H100
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const bf16 *q, *k, *v;
  const float *ig, *lf, *C0, *n0, *m0;
  bf16* h;
  float *C, *n, *m;
  int S, DH, L;
  int stage;  // bf16 elements of one q or k slice buffer (kStageBig or kStageSmall)
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Byte offsets of the parts of the dynamic shared memory, each 16-byte
// aligned. Two stages of [q slice | k slice]; a stage holds a k tile of the
// carry update too.
struct Smem {
  int Cs, ns, qk, vb, ss, dpart, qn, qp, red, cum, gi, arow, bcol, erow, wts, segA, segB, total;
  __host__ __device__ Smem(int DH, int TC, int L, int stage) {
    const int Lr = round4(L), nseg = round4((L + 31) / 32);
    int o = 0;
    Cs = o;    o += DH * (TC + 4) * 4;
    ns = o;    o += DH * 4;
    qk = o;    o += 2 * 2 * stage * 2;
    vb = o;    o += 2 * QB * (TC + 8) * 2;
    ss = o;    o += QB * SLD * 2;
    dpart = o; o += QB * 4 * 4;
    qn = o;    o += QB * 4;
    qp = o;    o += 4 * 16 * (TC + 8) * 4;
    red = o;   o += kThreads / 32 * 4;
    cum = o;   o += Lr * 4;
    gi = o;    o += Lr * 4;
    arow = o;  o += Lr * 4;
    bcol = o;  o += Lr * 4;
    erow = o;  o += Lr * 4;
    wts = o;   o += Lr * 4;
    segA = o;  o += nseg * 4;
    segB = o;  o += nseg * 4;
    total = o;
  }
};

// Passes of the carry update: each covers DW = DH / NP rows of C, a
// multiple of 8 and at most kUpd / TC (so that a q/k stage holds a tile of
// LT k rows: 16 (DW + 8) elements, at most 2 stage).
__host__ __device__ inline int update_passes(int DH, int TC) {
  int np = (DH * TC + kUpd - 1) / kUpd;
  while (DH % np != 0 || (DH / np) % 8 != 0) ++np;
  return np;
}

__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

template <int TC>
__global__ void __launch_bounds__(kThreads) mlstm_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = TC / 16;  // n8 tiles of h a warp owns
  constexpr int LDC = TC + 4;  // padded C row: the TF32 B fragment reads in distinct banks
  constexpr int LDV = TC + 8;  // padded v row: ldmatrix rows in distinct banks
  constexpr int LDP = TC + 8;  // padded row of a partial q C tile
  const int DH = a.DH, L = a.L, S = a.S;
  const int stage = a.stage;
  const Smem lay(DH, TC, L, stage);
  float* Cs = reinterpret_cast<float*>(smem + lay.Cs);
  float* ns = reinterpret_cast<float*>(smem + lay.ns);
  bf16* qkbuf = reinterpret_cast<bf16*>(smem + lay.qk);
  bf16* vbuf = reinterpret_cast<bf16*>(smem + lay.vb);
  bf16* ss = reinterpret_cast<bf16*>(smem + lay.ss);
  float* dpart = reinterpret_cast<float*>(smem + lay.dpart);
  float* qn_s = reinterpret_cast<float*>(smem + lay.qn);
  float* qpart = reinterpret_cast<float*>(smem + lay.qp);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* cum = reinterpret_cast<float*>(smem + lay.cum);
  float* gi = reinterpret_cast<float*>(smem + lay.gi);
  float* arow = reinterpret_cast<float*>(smem + lay.arow);  // cum_i - m_i
  float* bcol = reinterpret_cast<float*>(smem + lay.bcol);  // i_j - cum_j
  float* erow = reinterpret_cast<float*>(smem + lay.erow);  // exp(cum_i + m0 - m_i)
  float* wts = reinterpret_cast<float*>(smem + lay.wts);
  float* segA = reinterpret_cast<float*>(smem + lay.segA);
  float* segB = reinterpret_cast<float*>(smem + lay.segB);

  const int tile = blockIdx.x, bh = blockIdx.y, col0 = tile * TC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t dd2 = static_cast<size_t>(DH) * DH;

  // the first chunk's gates of this thread's first scan segment, loaded
  // before the copies below fill the memory pipeline
  float m_run = a.m0[bh];
  const int tt0 = warp * 32 + lane;
  float pf_lf = tt0 < L ? a.lf[static_cast<size_t>(bh) * S + tt0] : 0.f;
  float pf_ig = tt0 < L ? a.ig[static_cast<size_t>(bh) * S + tt0] : 0.f;
  // C0's tile and n0 by cp.async, all in flight from here on: the first
  // cp.async group, which the first chunk's first slice waits for
  constexpr int cpc = TC / 4;  // 16-byte copies per row of the C tile
  for (int e = tid; e < DH * cpc; e += kThreads) {
    const int r = e / cpc, c = (e % cpc) * 4;
    cp_async16(smem_u32(Cs + r * LDC + c), a.C0 + bh * dd2 + static_cast<size_t>(r) * DH + col0 + c,
               16);
  }
  for (int e = tid; e < DH / 4; e += kThreads) {
    cp_async16(smem_u32(ns + 4 * e), a.n0 + static_cast<size_t>(bh) * DH + 4 * e, 16);
  }
  cp_async_commit();

  const int R = min(QB, (L + 15) & ~15);  // staged rows of a group
  int KD = 512;                           // DH slice of a staged q or k tile
  while (R * (KD + 8) > stage) KD /= 2;
  const int LDQ = KD + 8;
  const int NSL = (DH + KD - 1) / KD;
  const int NQ = (L + QB - 1) / QB;
  const int nseg = (L + 31) / 32;
  const int NP = update_passes(DH, TC), DW = DH / NP;
  const int nlt = (L + LT - 1) / LT;
  // each thread's 16-byte column chunk and first row in the q/k slice
  // copies (KD / 8 chunks a row, rows hrs apart) and in the update's k tile
  // copies (DW / 8 chunks a row; threads past urs rows of them idle)
  const int hc8 = tid % (KD / 8) * 8, hr0 = tid / (KD / 8), hrs = kThreads / (KD / 8);
  const int uc8 = tid % (DW / 8) * 8, ur0 = tid / (DW / 8), urs = kThreads / (DW / 8);

  for (int c0 = 0; c0 < S; c0 += L) {
    const size_t row0 = static_cast<size_t>(bh) * S + c0;
    const float* ic = a.ig + row0;
    const float* lfc = a.lf + row0;
    const bf16* qc = a.q + row0 * DH;
    const bf16* kc = a.k + row0 * DH;
    const bf16* vc = a.v + row0 * DH;
    bf16* hc = a.h + row0 * DH;
    const bool last_chunk = c0 + L >= S;

    // q and k rows of (query group qg, key group kg), DH slice sl, into
    // buffer buf; with the pair's first slice, its v rows (this block's
    // columns) into the pair's v buffer. Rows past L are zero-filled.
    auto issue_h = [&](int qg, int kg, int sl, int buf, int pair) {
      const int d0 = sl * KD;
      bf16* qd = qkbuf + buf * 2 * stage;
      bf16* kd = qd + stage;
      if (d0 + hc8 < DH) {
        for (int r = hr0; r < R; r += hrs) {
          const int iq = qg * QB + r, ik = kg * QB + r;
          cp_async16(smem_u32(qd + r * LDQ + hc8),
                     iq < L ? qc + static_cast<size_t>(iq) * DH + d0 + hc8 : qc, iq < L ? 16 : 0);
          cp_async16(smem_u32(kd + r * LDQ + hc8),
                     ik < L ? kc + static_cast<size_t>(ik) * DH + d0 + hc8 : kc, ik < L ? 16 : 0);
        }
      }
      if (sl == 0) {
        constexpr int cpv = TC / 8;
        bf16* vd = vbuf + (pair & 1) * QB * LDV;
        for (int e = tid; e < R * cpv; e += kThreads) {
          const int r = e / cpv, c = (e % cpv) * 8, ik = kg * QB + r;
          cp_async16(smem_u32(vd + r * LDV + c),
                     ik < L ? vc + static_cast<size_t>(ik) * DH + col0 + c : vc, ik < L ? 16 : 0);
        }
      }
    };
    issue_h(0, 0, 0, 0, 0);
    cp_async_commit();

    // 1. gate scalars: cum, the row stabilisers, m', the carry weights
    for (int sg = warp; sg < nseg; sg += kThreads / 32) {
      const int tt = sg * 32 + lane;
      float x = sg == warp ? pf_lf : tt < L ? lfc[tt] : 0.f;
      if (tt < L) gi[tt] = sg == warp ? pf_ig : ic[tt];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (tt < L) cum[tt] = x;
      if (lane == 31) segA[sg] = x;
    }
    __syncthreads();
    for (int tt = tid; tt < L; tt += kThreads) {
      float off = 0.f;
      for (int sg = 0; sg < tt / 32; ++sg) off += segA[sg];
      cum[tt] += off;
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int sg = warp; sg < nseg; sg += kThreads / 32) {
      const int tt = sg * 32 + lane;
      float x = tt < L ? gi[tt] - cum[tt] : -INFINITY;
      if (tt < L) bcol[tt] = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = fmaxf(x, y);
      }
      if (tt < L) arow[tt] = x;
      if (lane == 31) segB[sg] = x;
    }
    __syncthreads();
    float amax = -INFINITY;
    for (int tt = tid; tt < L; tt += kThreads) {
      float pm = arow[tt];
      for (int sg = 0; sg < tt / 32; ++sg) pm = fmaxf(pm, segB[sg]);
      const float ct = cum[tt];
      const float mi = fmaxf(ct + pm, ct + m_run);
      arow[tt] = ct - mi;
      erow[tt] = expf((ct + m_run) - mi);
      amax = fmaxf(amax, (total - ct) + gi[tt]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    float mx = red[0];
    for (int w = 1; w < kThreads / 32; ++w) mx = fmaxf(mx, red[w]);
    const float m_new = fmaxf(total + m_run, mx);
    const float scale_old = expf((total + m_run) - m_new);
    for (int tt = tid; tt < L; tt += kThreads) wts[tt] = expf(((total - cum[tt]) + gi[tt]) - m_new);

    // 2. h, one pipeline over the slices of every (query group, key group)
    //    pair, kg <= qg. Warp w owns h's rows 16 (w / 2) of the group and
    //    columns [(w % 2) TC / 2, (w % 2 + 1) TC / 2) of the tile, and the
    //    score blocks 7 - w and 15 - w (row block b / 4, key block b % 4) of
    //    each pair's 64 x 64 panel (so at L <= 16 the one live block is not
    //    on a warp that owns h).
    // carry-update tile u (pass u / nlt, steps (u % nlt) LT ...): its k
    //    rows (the pass's DW columns) into q/k stage kb, its v rows (this
    //    block's columns) into v buffer vb
    const int LDK = DW + 8;
    auto issue_u = [&](int u, int kb, int vb) {
      const int p = u / nlt, l0 = (u % nlt) * LT;
      bf16* kd = qkbuf + kb * 2 * stage;
      if (ur0 < urs) {
        for (int r = ur0; r < LT; r += urs) {
          const int l = l0 + r;
          cp_async16(smem_u32(kd + r * LDK + uc8),
                     l < L ? kc + static_cast<size_t>(l) * DH + p * DW + uc8 : kc, l < L ? 16 : 0);
        }
      }
      constexpr int cpv = TC / 8;
      bf16* vd = vbuf + vb * QB * LDV;
      for (int e = tid; e < LT * cpv; e += kThreads) {
        const int r = e / cpv, c = (e % cpv) * 8, l = l0 + r;
        cp_async16(smem_u32(vd + r * LDV + c),
                   l < L ? vc + static_cast<size_t>(l) * DH + col0 + c : vc, l < L ? 16 : 0);
      }
    };
    float acc[2][2][2][4], hv[NT][4], qcc[2][NT][4];
    float dsum_lo = 0.f, dsum_hi = 0.f, qn_a = 0.f, qn_b = 0.f;
    const int own_n = (warp & 1) * NT * 8;
    int qg = 0, kg = 0, sl = 0, pair = 0;
    int ukb = 0, uvb = 0;  // the stage and v buffer of the update's first tile
    for (int s = 0;; ++s) {
      int nq = qg, nk = kg, nsl = sl + 1, np = pair;
      if (nsl == NSL) {
        nsl = 0;
        ++np;
        if (++nk > nq) {
          nk = 0;
          ++nq;
        }
      }
      const bool more = nq < NQ;
      if (more) {
        issue_h(nq, nk, nsl, (s + 1) & 1, np);
        cp_async_commit();
        cp_async_wait<1>();
      } else {  // the last step: the update's first tile into the free buffers
        ukb = (s + 1) & 1;
        uvb = (pair + 1) & 1;
        issue_u(0, ukb, uvb);
        cp_async_commit();
        cp_async_wait<1>();
      }
      __syncthreads();

      // the group's P live 16-row tiles (1, 2 or 4): warp pair pw owns h's
      // tile pw (pw < P); q C's 16-steps are split KS = 4 / P ways, so at a
      // short L the warp pairs that own no rows take a share
      const int mtl = min(4, (L - qg * QB + 15) / 16);
      const int P = mtl == 1 ? 1 : mtl == 2 ? 2 : 4, KS = 4 / P;
      const int pw = warp >> 1, own_mt = pw % P, kpart = pw / P;
      const int d0 = sl * KD, dn = min(KD, DH - d0);
      const bf16* qs = qkbuf + (s & 1) * 2 * stage;
      const bf16* ks = qs + stage;
      if (sl == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[i][u][hh][c] = 0.f;
        if (kg == 0) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) hv[j][c] = qcc[0][j][c] = qcc[1][j][c] = 0.f;
          dsum_lo = dsum_hi = qn_a = qn_b = 0.f;
        }
      }
      // scores of this slice
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = 7 - warp + 8 * i, mt = b >> 2, kb = b & 3;
        const int r0 = qg * QB + mt * 16, j0 = kg * QB + kb * 16;
        if (r0 < L && j0 < L && j0 <= r0 + 15) {
          const unsigned qa0 = smem_u32(qs + (mt * 16 + (lane & 15)) * LDQ + (lane >> 4) * 8);
          const unsigned kb0 =
              smem_u32(ks + (kb * 16 + (lane >> 4) * 8 + (lane & 7)) * LDQ + ((lane >> 3) & 1) * 8);
#pragma unroll 2
          for (int kk = 0; kk < dn / 16; kk += 2) {  // two chains: even and odd 16-steps
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              unsigned qa[4], b0, b1, b2, b3;
              ldsm_x4(qa0 + (kk + u) * 32, qa[0], qa[1], qa[2], qa[3]);
              ldsm_x4(kb0 + (kk + u) * 32, b0, b1, b2, b3);
              mma_bf16(acc[i][u][0], qa, b0, b1);
              mma_bf16(acc[i][u][1], qa, b2, b3);
            }
          }
        }
      }
      // q C (TF32) and q . n of this slice, once per query group
      if (kg == 0) {
        if (qg * QB + own_mt * 16 < L) {
          const unsigned qa0 = smem_u32(qs + (own_mt * 16 + (lane & 15)) * LDQ + (lane >> 4) * 8);
          const float* cb = Cs + (d0 + 2 * t) * LDC + own_n + g;
          const int nk16 = dn / 16;
#pragma unroll 2
          for (int kk = kpart; kk < nk16; kk += 2 * KS) {  // this warp's share of the 16-steps
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (kk + u * KS >= nk16) break;
              unsigned qa[4];
              ldsm_x4(qa0 + (kk + u * KS) * 32, qa[0], qa[1], qa[2], qa[3]);
              const float* cr = cb + (kk + u * KS) * 16 * LDC;
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                // k index 2t -> t, 2t + 1 -> t + 4 in each 8-step
                mma_tf32(qcc[u][j], qa[0] << 16, qa[1] << 16, qa[0] & 0xffff0000u,
                         qa[1] & 0xffff0000u, __float_as_uint(cr[j * 8]),
                         __float_as_uint(cr[LDC + j * 8]));
                mma_tf32(qcc[u][j], qa[2] << 16, qa[3] << 16, qa[2] & 0xffff0000u,
                         qa[3] & 0xffff0000u, __float_as_uint(cr[8 * LDC + j * 8]),
                         __float_as_uint(cr[9 * LDC + j * 8]));
              }
            }
          }
        }
        // q . n: TPR consecutive lanes a row, 8-column chunks strided
        const int TPR = R <= 16 ? 16 : R <= 32 ? 8 : 4;
        const int r = tid / TPR, j8 = tid % TPR;
        if (r < R) {
          const bf16* qrow = qs + r * LDQ;
          const float* nrow = ns + d0;
#pragma unroll 4
          for (int c = j8 * 8; c < dn; c += TPR * 8) {
            const uint4 u = *reinterpret_cast<const uint4*>(qrow + c);
            const float4 na = *reinterpret_cast<const float4*>(nrow + c);
            const float4 nb = *reinterpret_cast<const float4*>(nrow + c + 4);
            qn_a = fmaf(bf_lo(u.x), na.x, qn_a);
            qn_b = fmaf(bf_hi(u.x), na.y, qn_b);
            qn_a = fmaf(bf_lo(u.y), na.z, qn_a);
            qn_b = fmaf(bf_hi(u.y), na.w, qn_b);
            qn_a = fmaf(bf_lo(u.z), nb.x, qn_a);
            qn_b = fmaf(bf_hi(u.z), nb.y, qn_b);
            qn_a = fmaf(bf_lo(u.w), nb.z, qn_a);
            qn_b = fmaf(bf_hi(u.w), nb.w, qn_b);
          }
        }
        if (sl == NSL - 1) {
          float x = qn_a + qn_b;
          for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
          if (j8 == 0) qn_s[r] = x;
          if (kpart > 0) {  // this warp's partial q C, for the warp that owns the rows
            float* qp = qpart + pw * 16 * LDP + own_n + 2 * t;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              *reinterpret_cast<float2*>(qp + g * LDP + j * 8) =
                  make_float2(qcc[0][j][0] + qcc[1][j][0], qcc[0][j][1] + qcc[1][j][1]);
              *reinterpret_cast<float2*>(qp + (g + 8) * LDP + j * 8) =
                  make_float2(qcc[0][j][2] + qcc[1][j][2], qcc[0][j][3] + qcc[1][j][3]);
            }
          }
        }
      }

      if (sl == NSL - 1) {
        // the pair's panel: mask, decay; the scores rounded to bf16 (as s v
        // takes them) and their unrounded f32 row sums to shared memory
        // (zeros for blocks no warp computed)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int b = 7 - warp + 8 * i, mt = b >> 2, kb = b & 3;
          const int r0 = qg * QB + mt * 16, j0 = kg * QB + kb * 16;
          const bool live = r0 < L && j0 < L && j0 <= r0 + 15;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int row = r0 + g + 8 * (c >> 1), key = j0 + hh * 8 + 2 * t + (c & 1);
              const float dec = __expf(arow[min(row, L - 1)] + bcol[min(key, L - 1)]);
              const float qk = acc[i][0][hh][c] + acc[i][1][hh][c];
              acc[i][0][hh][c] = live && row < L && key <= row ? qk * dec : 0.f;
            }
            bf16* srow = ss + (mt * 16 + g) * SLD + kb * 16 + hh * 8 + 2 * t;
            const float* sv = acc[i][0][hh];
            *reinterpret_cast<unsigned*>(srow) = pack_bf16(sv[0], sv[1]);
            *reinterpret_cast<unsigned*>(srow + 8 * SLD) = pack_bf16(sv[2], sv[3]);
          }
          const float(&s0)[4] = acc[i][0][0];
          const float(&s1)[4] = acc[i][0][1];
          float lo = (s0[0] + s0[1]) + (s1[0] + s1[1]);
          float hi = (s0[2] + s0[3]) + (s1[2] + s1[3]);
          lo += __shfl_xor_sync(kFull, lo, 1);
          hi += __shfl_xor_sync(kFull, hi, 1);
          lo += __shfl_xor_sync(kFull, lo, 2);
          hi += __shfl_xor_sync(kFull, hi, 2);
          if (t == 0) {
            dpart[(mt * 16 + g) * 4 + kb] = lo;
            dpart[(mt * 16 + g + 8) * 4 + kb] = hi;
          }
        }
        __syncthreads();
        const int r0 = qg * QB + own_mt * 16;
        if (r0 < L && kpart == 0) {
          // s v: s and v by ldmatrix (.trans for v)
          const bf16* vs = vbuf + (pair & 1) * QB * LDV;
          const unsigned sa0 = smem_u32(ss + (own_mt * 16 + (lane & 15)) * SLD + (lane >> 4) * 8);
          for (int kk = 0; kk < 4; ++kk) {
            const int j0 = kg * QB + kk * 16;
            if (j0 >= L || j0 > r0 + 15) break;
            unsigned pa[4];
            ldsm_x4(sa0 + kk * 32, pa[0], pa[1], pa[2], pa[3]);
            const bf16* vrow = vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + own_n;
            if constexpr (NT == 1) {
              unsigned b0, b1;
              ldsm_x2_t(smem_u32(vrow), b0, b1);
              mma_bf16(hv[0], pa, b0, b1);
            } else {
              unsigned b0, b1, b2, b3;
              ldsm_x4_t(smem_u32(vrow + (lane >> 4) * 8), b0, b1, b2, b3);
              mma_bf16(hv[0], pa, b0, b1);
              mma_bf16(hv[NT - 1], pa, b2, b3);
            }
          }
#pragma unroll
          for (int kb = 0; kb < 4; ++kb) {
            dsum_lo += dpart[(own_mt * 16 + g) * 4 + kb];
            dsum_hi += dpart[(own_mt * 16 + g + 8) * 4 + kb];
          }
          if (kg == qg) {  // the group's last pair: h
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int rl = own_mt * 16 + g + 8 * hf, row = qg * QB + rl;
              if (row < L) {
                const float e = erow[row];
                const float den = fmaxf(fabsf((hf ? dsum_hi : dsum_lo) + e * qn_s[rl]), 1.f);
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                  float qc0 = qcc[0][j][2 * hf] + qcc[1][j][2 * hf];
                  float qc1 = qcc[0][j][2 * hf + 1] + qcc[1][j][2 * hf + 1];
                  for (int kp = 1; kp < KS; ++kp) {  // the other warps' shares, in order
                    const float2 x = *reinterpret_cast<const float2*>(
                        qpart + ((own_mt + P * kp) * 16 + g + 8 * hf) * LDP + own_n + j * 8 + 2 * t);
                    qc0 += x.x;
                    qc1 += x.y;
                  }
                  const float h0 = (hv[j][2 * hf] + e * qc0) / den;
                  const float h1 = (hv[j][2 * hf + 1] + e * qc1) / den;
                  *reinterpret_cast<__nv_bfloat162*>(hc + static_cast<size_t>(row) * DH + col0 +
                                                     own_n + j * 8 + 2 * t) =
                      __floats2bfloat162_rn(h0, h1);
                }
              }
            }
          }
        }
      }
      __syncthreads();  // the buffers read here are the next steps' load targets
      if (!more) break;
      qg = nq;
      kg = nk;
      sl = nsl;
      pair = np;
    }

    // 3. carry update, exact f32: C = scale_old C + sum_l (k_l w_l) v_l^T,
    //    n alike, in passes of DW rows; thread (rg, cg) holds rows
    //    [8 rg, 8 rg + 8) of the pass and columns [4 cg, 4 cg + 4) in
    //    registers, and reads a step's 8 k, 4 v and w from shared memory
    //    once for its 32 FMAs. k and v tiles of LT steps by cp.async,
    //    double-buffered.
    constexpr int cgs = TC / 4;
    const int cg = tid % cgs, rg = tid / cgs;
    const bool act = rg * 8 < DW;
    float creg[8][4], nreg[8];
    const int NU = NP * nlt;
    if (!last_chunk) {  // the next chunk's gates of this thread's first scan segment
      pf_lf = tt0 < L ? lfc[L + tt0] : 0.f;
      pf_ig = tt0 < L ? ic[L + tt0] : 0.f;
    }
    for (int u = 0; u < NU; ++u) {
      if (u + 1 < NU) {
        issue_u(u + 1, (ukb + u + 1) & 1, (uvb + u + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int p = u / nlt, lt = u % nlt, l0 = lt * LT;
      const int d0 = p * DW + rg * 8;
      if (act) {
        if (lt == 0) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(Cs + (d0 + r) * LDC + cg * 4);
            creg[r][0] = x.x * scale_old;
            creg[r][1] = x.y * scale_old;
            creg[r][2] = x.z * scale_old;
            creg[r][3] = x.w * scale_old;
            nreg[r] = ns[d0 + r] * scale_old;
          }
        }
        const bf16* kd = qkbuf + ((ukb + u) & 1) * 2 * stage + rg * 8;
        const bf16* vd = vbuf + ((uvb + u) & 1) * QB * LDV + cg * 4;
        const int ln = min(LT, L - l0);
#pragma unroll 4
        for (int l = 0; l < ln; ++l) {
          const uint4 ku = *reinterpret_cast<const uint4*>(kd + l * LDK);
          const uint2 vu = *reinterpret_cast<const uint2*>(vd + l * LDV);
          const float w = wts[l0 + l];
          const unsigned kk[4] = {ku.x, ku.y, ku.z, ku.w};
          const float vf[4] = {bf_lo(vu.x), bf_hi(vu.x), bf_lo(vu.y), bf_hi(vu.y)};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float kw = (r & 1 ? bf_hi(kk[r / 2]) : bf_lo(kk[r / 2])) * w;
#pragma unroll
            for (int c = 0; c < 4; ++c) creg[r][c] = fmaf(kw, vf[c], creg[r][c]);
            nreg[r] += kw;
          }
        }
        if (lt == nlt - 1) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 x = make_float4(creg[r][0], creg[r][1], creg[r][2], creg[r][3]);
            if (last_chunk) {
              *reinterpret_cast<float4*>(a.C + bh * dd2 + static_cast<size_t>(d0 + r) * DH + col0 +
                                         cg * 4) = x;
              if (cg == 0 && tile == 0) a.n[static_cast<size_t>(bh) * DH + d0 + r] = nreg[r];
            } else {
              *reinterpret_cast<float4*>(Cs + (d0 + r) * LDC + cg * 4) = x;
              if (cg == 0) ns[d0 + r] = nreg[r];
            }
          }
        }
      }
      __syncthreads();
    }
    m_run = m_new;
  }
  if (tile == 0 && tid == 0) a.m[bh] = m_run;
}

template <int TC>
cudaError_t launch(Args a, int BH, cudaStream_t s) {
  static int smem_set = 0;  // the largest dynamic shared memory opted into so far
  a.stage = Smem(a.DH, TC, a.L, kStageBig).total <= kMaxSmem ? kStageBig : kStageSmall;
  const int smem = Smem(a.DH, TC, a.L, a.stage).total;
  if (smem > kMaxSmem || a.DH % TC != 0) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(mlstm_tc_kernel<TC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  mlstm_tc_kernel<TC><<<dim3(a.DH / TC, BH), kThreads, smem, s>>>(a);
  return cudaSuccess;
}

}  // namespace tc

}  // namespace

// q, k, v, h: (BH, S, DH); i, lf: (BH, S); C0, C: (BH, DH, DH); n0, n: (BH, DH);
// m0, m: (BH); all contiguous. DH a multiple of 32, 1 <= L, S % L == 0.
// bf16: TC (16 or 32) columns of C a block, 16-byte aligned q, k, v, h, C0,
// n0 and C, scratch unused, L bounded by shared memory (see above). f32: 32
// columns a block (TC is not read), scratch BH * (DH / 32) * 3 * L floats,
// DH up to 1024.
extern "C" int rt_mlstm_chunkwise(const void* q, const void* k, const void* v, const float* i,
                                  const float* lf, const float* C0, const float* n0,
                                  const float* m0, void* h, float* C, float* n, float* m,
                                  float* scratch, int BH, int S, int DH, int L, int TC, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH > 0 && S > 0 && L > 0 && S % L == 0 && DH % 32 == 0 && DH > 0) {
    cudaError_t err;
    if (dtype == rt::kBF16) {
      using bf16 = __nv_bfloat16;
      const tc::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), i, lf, C0, n0, m0, static_cast<bf16*>(h),
                       C, n, m, S, DH, L, 0};
      const bool aligned = rt::aligned(q, 16) && rt::aligned(k, 16) && rt::aligned(v, 16) &&
                           rt::aligned(h, 16) && rt::aligned(C0, 16) && rt::aligned(C, 16) &&
                           rt::aligned(n0, 16);
      err = !aligned ? cudaErrorInvalidValue
            : TC == 16 ? tc::launch<16>(a, BH, s)
            : TC == 32 ? tc::launch<32>(a, BH, s)
                       : cudaErrorInvalidValue;
    } else {
      err = launch<float>(q, k, v, i, lf, C0, n0, m0, h, C, n, m, scratch, BH, S, DH, L, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
