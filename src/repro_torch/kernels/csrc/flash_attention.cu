// Causal GQA flash attention, forward: q (B, H, S, hd), k/v (B, KV, S, hd),
// KV head of query head h = h / (H / KV); f32 softmax, output in q's dtype.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py :: flash_attention_bhsd
// (no softcap and no position offsets, like the TPU kernel).
//
// Bound on the H100: at the serving path's prompt lengths (S <= 96, hd = 64)
// the kernel is bound by memory bytes and launch latency; at long S the
// attention products would bind, and this kernel's f32 FMA loops (no tensor
// cores yet) would sit far from the card's bf16 peak.
//
// Design: one block per (query tile of BQ rows, head, batch). The TPU grid
// walks kv blocks sequentially with a VMEM carry; here a loop inside the
// block walks the kv tiles up to the causal limit of its query tile, so
// fully masked tiles are skipped. Per tile, K and V are staged in shared
// memory as f32 (q and K rows padded to hd + 1 floats against bank
// conflicts), threads r < BQ keep row r's running max and sum in registers,
// and each thread keeps its share of the BQ x hd accumulator in registers.
// The ragged edge (S not a multiple of the tile) is masked in place: rows and
// keys past S load as zeros, keys past S are masked, rows past S are never
// stored. No padded copy of the inputs is made.
#include "common.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BKV = 32;
constexpr int kThreads = 128;
constexpr int kMaxHd = 128;
constexpr int kAccPerThread = BQ * kMaxHd / kThreads;

size_t smem_bytes(int hd) {
  const size_t ld = hd + 1;
  return sizeof(float) * (BQ * ld + BKV * ld + static_cast<size_t>(BKV) * hd + BQ * BKV + BQ);
}

template <typename T>
__global__ void flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                                 int S, int hd, float scale) {
  extern __shared__ float sm[];
  const int LD = hd + 1;
  float* q_s = sm;               // BQ * LD
  float* k_s = q_s + BQ * LD;    // BKV * LD
  float* v_s = k_s + BKV * LD;   // BKV * hd
  float* p_s = v_s + BKV * hd;   // BQ * BKV: scores, then probabilities
  float* c_s = p_s + BQ * BKV;   // BQ: per-tile correction, then the sums

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int q0 = iq * BQ;
  const size_t shd = static_cast<size_t>(S) * hd;
  const T* qb = q + (static_cast<size_t>(b) * H + h) * shd;
  const T* kb = k + (static_cast<size_t>(b) * KV + kvh) * shd;
  const T* vb = v + (static_cast<size_t>(b) * KV + kvh) * shd;
  T* ob = o + (static_cast<size_t>(b) * H + h) * shd;

  for (int i = tid; i < BQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    q_s[r * LD + d] = q0 + r < S ? rt::to_f(qb[static_cast<size_t>(q0 + r) * hd + d]) : 0.f;
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;
  float m_run = rt::kNegInf, l_run = 0.f;  // live on threads tid < BQ

  const int q_last = min(q0 + BQ, S) - 1;
  const int n_kv = q_last / BKV + 1;  // causal tile skipping
  for (int ik = 0; ik < n_kv; ++ik) {
    const int k0 = ik * BKV;
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BKV * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const bool in = k0 + r < S;
      const size_t off = static_cast<size_t>(k0 + r) * hd + d;
      k_s[r * LD + d] = in ? rt::to_f(kb[off]) : 0.f;
      v_s[i] = in ? rt::to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    for (int idx = tid; idx < BQ * BKV; idx += kThreads) {
      const int r = idx / BKV, c = idx % BKV;
      const float* qr = q_s + r * LD;
      const float* kr = k_s + c * LD;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
      const int qpos = q0 + r, kpos = k0 + c;
      p_s[idx] = (kpos > qpos || kpos >= S) ? rt::kNegInf : dot * scale;
    }
    __syncthreads();

    if (tid < BQ) {
      float* pr = p_s + tid * BKV;
      float mx = m_run;
      for (int c = 0; c < BKV; ++c) mx = fmaxf(mx, pr[c]);
      const float corr = expf(m_run - mx);
      float sum = 0.f;
      for (int c = 0; c < BKV; ++c) {
        const float p = expf(pr[c] - mx);
        pr[c] = p;
        sum += p;
      }
      l_run = l_run * corr + sum;
      m_run = mx;
      c_s[tid] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < BQ * hd) {
        const int r = e / hd, d = e % hd;
        const float* pr = p_s + r * BKV;
        float a = acc[j] * c_s[r];
        for (int c = 0; c < BKV; ++c) a += pr[c] * v_s[c * hd + d];
        acc[j] = a;
      }
    }
  }

  __syncthreads();
  if (tid < BQ) c_s[tid] = l_run;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < BQ * hd) {
      const int r = e / hd, d = e % hd;
      if (q0 + r < S) {
        ob[static_cast<size_t>(q0 + r) * hd + d] = rt::from_f<T>(acc[j] / fmaxf(c_s[r], 1e-30f));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int S, int hd, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, S, hd, scale);
  return cudaSuccess;
}

}  // namespace

// q/o: (B, H, S, hd); k/v: (B, KV, S, hd); all contiguous, hd <= 128.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int KV, int S, int hd, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && S > 0 && hd <= kMaxHd) {
    cudaError_t err = dtype == rt::kBF16
                          ? launch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, hd, scale, s)
                          : launch<float>(q, k, v, o, B, H, KV, S, hd, scale, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
