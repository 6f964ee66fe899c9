// One-token GQA decode attention for Hopper (sm_90a), contiguous and paged.
//
// Replaces the TPU kernels in src/repro/kernels/decode_attention.py:
//   decode_attention        (_dec_kernel, pallas_call at :127)
//   paged_decode_attention  (_paged_dec_kernel, pallas_call at :249)
//
// What it computes: for each row b and query head, softmax attention of the
// single query (sitting at position lengths[b]-1) over the positions
// pos < lengths[b] with lengths[b]-1-pos < window, scores and online
// softmax in float32.  Contiguous K/V are (B, S, Hkv, D) slot stripes; paged
// K/V are (NB, bs, Hkv, D) block pools read through tables (B, MB), with an
// optional int8 mode whose per-position float32 scales (NB, bs) are applied
// to each element right after the load.  Both layouts are read in place
// (no (B, Hkv, S, D) copy: that was a TPU BlockSpec need).
//
// Bound on the H100: bytes.  Each live K/V element is used for 2G
// multiply-adds (G = H / Hkv query heads per KV head, 2 for internlm2), far
// below the ~295 operations per byte where the tensor cores would bound.
// The design therefore reads every live K/V byte exactly once:
//   * one CTA per (row b, KV head h) loads the G query rows once and reuses
//     each K/V element for all G heads;
//   * tiles wholly past lengths[b] (or before the window) are never loaded,
//     which is where the paged kernel saves bytes over a gathered view;
//   * the paged kernel reads tables[b, pos / bs] itself (Hopper has no
//     scalar prefetch) and never materialises the gathered sequence.
// Masked lanes get p = 0 explicitly, not exp(NEG_INF - NEG_INF), the TPU
// kernel's own guard.
//
// Each tile of 32 positions is staged into shared memory by independent,
// coalesced loads (one per head dim and position) before any arithmetic,
// so a CTA waits on memory about once per tile, not once per position.
// Head dims up to 128 (one thread per output dim).
//
// Known limit: the grid is B * Hkv CTAs (64 at 8 rows of internlm2), fewer
// than the card's 132 SMs, so one decode step cannot reach the memory rate.
// Splitting the sequence across CTAs (split-K with a merge pass) is later
// work; so are TMA/cp.async staging of the K/V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // positions per tile: one per lane in the softmax
constexpr int kMaxG = 8;    // query heads per KV head
constexpr int kMaxD = 128;  // head dim: one thread per dim of the output
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Args {
  const void* q;          // (B, H, D)
  const void* k;          // contiguous (B, S, Hkv, D) | paged (NB, bs, Hkv, D)
  const void* v;
  const float* k_scale;   // paged int8 only: (NB, bs)
  const float* v_scale;
  const int32_t* tables;  // paged only: (B, MB)
  const int32_t* lengths; // (B,)
  void* out;              // (B, H, D), q's dtype
  int H, Hkv, D;
  int S;                  // contiguous: stripe length; paged: block size bs
  int MB;                 // paged: table width
  int window;
  float scale;
};

// QT: query/output element type; KT: stored K/V element type.
template <typename QT, typename KT, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const QT* q = static_cast<const QT*>(a.q);
  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);

  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float k_s[kTile][kMaxD];  // the tile, dequantized to float
  __shared__ float v_s[kTile][kMaxD];
  __shared__ float p_s[kMaxG][kTile];  // scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ long long row_s[kTile];   // element offset of (pos, h, 0); -1 = dead
  __shared__ float ks_s[kTile], vs_s[kTile];
  __shared__ bool ok_s[kTile];         // inside the live prefix and window

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g][d] = to_f32(q[((long long)b * a.H + h * G + g) * D + d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kMaxG];  // output dim d = tid, for each query head
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  const int len = a.lengths[b];
  const int limit = PAGED ? a.MB * a.S : a.S;   // positions that exist
  const int n = len < limit ? len : limit;
  const int lo = (a.window < len) ? len - a.window : 0;  // first in window
  __syncthreads();

  for (int t0 = (lo / kTile) * kTile; t0 < n; t0 += kTile) {
    // (a) where each position of the tile lives
    if (tid < kTile) {
      const int pos = t0 + tid;
      long long row = -1;
      float ksc = 1.f, vsc = 1.f;
      if (pos < n) {
        if (PAGED) {
          const int pid = a.tables[(long long)b * a.MB + pos / a.S];
          const long long slot = (long long)pid * a.S + pos % a.S;
          row = (slot * a.Hkv + h) * D;
          if (a.k_scale != nullptr) {
            ksc = a.k_scale[slot];
            vsc = a.v_scale[slot];
          }
        } else {
          row = (((long long)b * a.S + pos) * a.Hkv + h) * D;
        }
      }
      row_s[tid] = row;
      ok_s[tid] = row >= 0 && pos >= lo;
      ks_s[tid] = ksc;
      vs_s[tid] = vsc;
    }
    __syncthreads();

    // (b) stage the K/V tile: thread d loads dim d of every position into
    // registers first (read-only global loads, all independent and
    // coalesced across the warp, so they are in flight together; a store
    // to shared memory between them would order each load after it), then
    // scales and stores them
    if (tid < D) {
      KT kr[kTile], vr[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const long long row = row_s[t] >= 0 ? row_s[t] : 0;
        kr[t] = __ldg(k + row + tid);
        vr[t] = __ldg(v + row + tid);
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const bool live = row_s[t] >= 0;
        k_s[t][tid] = live ? to_f32(kr[t]) * ks_s[t] : 0.f;
        v_s[t][tid] = live ? to_f32(vr[t]) * vs_s[t] : 0.f;
      }
    }
    __syncthreads();

    // (c) scores: one warp per position, lanes stride over the head dim
    for (int t = warp; t < kTile; t += kWarps) {
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kf = k_s[t][d];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s[g] += q_s[g][d] * kf;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) s[g] = warp_sum(s[g]);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) p_s[g][t] = ok_s[t] ? s[g] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // (d) online softmax: one warp per query head, one lane per position;
    // masked lanes get p = 0 explicitly
    for (int g = warp; g < G; g += kWarps) {
      const bool ok = ok_s[lane];
      const float s = p_s[g][lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(ok ? s : kNegInf));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      p_s[g][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // (e) rescale and accumulate p @ V from shared memory
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= corr_s[g];
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float vf = v_s[t][tid];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += p_s[g][t] * vf;
      }
    }
    __syncthreads();
  }

  if (tid < D) {
    QT* out = static_cast<QT*>(a.out);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
        store(out + ((long long)b * a.H + h * G + g) * D + tid,
              acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

// dtype codes shared with the Python wrapper
enum { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <bool PAGED>
int launch(const Args& a, int B, int q_dtype, int kv_dtype,
           cudaStream_t stream) {
  const dim3 grid(B * a.Hkv), block(kThreads);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    decode_kernel<__nv_bfloat16, __nv_bfloat16, PAGED>
        <<<grid, block, 0, stream>>>(a);
  else if (q_dtype == kF32 && kv_dtype == kF32)
    decode_kernel<float, float, PAGED><<<grid, block, 0, stream>>>(a);
  else if (PAGED && q_dtype == kBF16 && kv_dtype == kI8)
    decode_kernel<__nv_bfloat16, int8_t, PAGED>
        <<<grid, block, 0, stream>>>(a);
  else if (PAGED && q_dtype == kF32 && kv_dtype == kI8)
    decode_kernel<float, int8_t, PAGED><<<grid, block, 0, stream>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int decode_attention_contiguous(const void* q, const void* k, const void* v,
                                const int32_t* lengths, void* out, int B,
                                int H, int Hkv, int D, int S, int window,
                                float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (H % Hkv || H / Hkv > kMaxG || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, nullptr, nullptr, nullptr, lengths, out,
         H, Hkv, D, S, 0, window, scale};
  return launch<false>(a, B, q_dtype, kv_dtype,
                       static_cast<cudaStream_t>(stream));
}

int decode_attention_paged(const void* q, const void* k_pool,
                           const void* v_pool, const float* k_scale,
                           const float* v_scale, const int32_t* tables,
                           const int32_t* lengths, void* out, int B, int H,
                           int Hkv, int D, int bs, int MB, int window,
                           float scale, int q_dtype, int kv_dtype,
                           void* stream) {
  if (H % Hkv || H / Hkv > kMaxG || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
         H, Hkv, D, bs, MB, window, scale};
  return launch<true>(a, B, q_dtype, kv_dtype,
                      static_cast<cudaStream_t>(stream));
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
