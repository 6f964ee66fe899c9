// Causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention  (_fa_kernel at :24, wrapper at :68, pallas_call at :91)
//
// What it computes: for q (B, S, H, D) and k, v (B, S, Hkv, D) with
// H % Hkv == 0, softmax attention of query position i of head h over key
// positions j of KV head h / (H / Hkv) with j < S and, when causal,
// j <= i and i - j < window; scores, softmax and the output sums in
// float32, the output cast to q's dtype.  It also writes the per-row
// log-sum-exp (B, H, S) float32 of the scaled, masked scores, which the
// backward pass uses to recompute the probabilities.  A row with no live
// key gets p = 0 everywhere (zeros out), not exp(NEG_INF - NEG_INF).
//
// Bound on the H100: at the training shape (16 rows, S = 143, H 16, Hkv 8,
// D 128, bf16) q, k, v and the output are 28 MB, 8 us at 3.35 TB/s, while
// the causal products are 1.3 GFLOP, 1.4 us at 989 TFLOP/s: bytes bound.
// At S = 4096 the products grow as S^2 (137 GFLOP for 2 rows, 0.14 ms) and
// operations bound.  The design:
//   * one CTA of 4 warps per (row b, query head h, 64-row query tile); each
//     warp owns 16 query rows;
//   * the CTA walks 64-position K/V tiles from the first one inside the
//     window up to the diagonal, so tiles wholly above the diagonal or
//     wholly before the window are never loaded;
//   * q, k, v and the output are read and written in their (B, S, H, D)
//     layouts through strides: no (B, H, S, D) copy and no padding copy
//     (both were TPU BlockSpec needs); positions past S load as zeros;
//   * each tile is loaded into registers with 16-byte __ldg loads before
//     any of it is stored to shared memory, so its loads are in flight
//     together;
//   * bf16: Q K^T and P V run on the tensor cores through nvcuda::wmma
//     16x16x16 bf16 fragments with float32 accumulation (P rounded to bf16
//     for the second product, as the JAX direct path casts its weights to
//     v's dtype); float32 inputs take a scalar FMA path in full float32;
//   * the online softmax (running max, rescaled sum) is kept in float32
//     registers per row; the output accumulator lives in shared memory in
//     float32 and is rescaled row by row.
// Head dims that are multiples of 16 up to 128.
//
// Known limits, later work: no wgmma, TMA, cp.async pipelining or warp
// specialisation; the output accumulator makes a shared-memory round trip
// per tile; 110 KB of shared memory per CTA (bf16) allows two CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;            // query rows per warp
constexpr int kBq = kWarps * kRows;  // query rows per CTA
constexpr int kBk = 64;              // key positions per tile
constexpr int kMaxD = 128;
constexpr int kPad = 8;              // row padding (elements) of Q/K/V/P
constexpr int kLdS = kBk + 4;        // float score tile row stride
constexpr int kLdP = kBk + kPad;     // probability tile row stride
constexpr int kChunk = 8;            // 16-byte vectors per thread per pass
constexpr float kNegInf = -1.0e30f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
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
  const void* q;   // (B, S, H, D)
  const void* k;   // (B, S, Hkv, D)
  const void* v;
  void* out;       // (B, S, H, D), q's dtype
  float* lse;      // (B, H, S) contiguous
  long long q_sb, q_ss, q_sh;  // element strides (batch, position, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, H, Hkv, D;
  int causal, window;
  float scale;
};

// Shared-memory layout of one CTA, in bytes, for element type T.
template <typename T>
struct Smem {
  int ld, ldo;                       // Q/K/V row stride; output row stride
  size_t q, k, v, s, p, o, total;    // offsets
  __host__ __device__ explicit Smem(int D) {
    ld = D + kPad;
    ldo = D + 4;
    const size_t tile = (size_t)kBq * ld * sizeof(T);  // kBq == kBk
    q = 0;
    k = q + tile;
    v = k + tile;
    s = v + tile;
    p = s + (size_t)kBq * kLdS * sizeof(float);
    o = p + (size_t)kBq * kLdP * sizeof(T);
    total = o + (size_t)kBq * ldo * sizeof(float);
  }
};

// Rows [pos0, pos0 + 64) of one head of a (B, S, heads, D) tensor into a
// padded shared tile (rows at or past S are zeros).  Two tiles per call
// (src1 may be null), each pass loading up to kChunk 16-byte vectors per
// thread of each into registers before storing any of them.
template <typename T>
__device__ __forceinline__ void load_tiles(
    T* dst0, const T* src0, long long ss0, T* dst1, const T* src1,
    long long ss1, int ld, int pos0, int nvalid, int D, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = D / kVec;            // vectors per row
  const int total = kBk * vpr;
  for (int base = 0; base < total; base += kThreads * kChunk) {
    uint4 r0[kChunk], r1[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = base + j * kThreads + tid;
      const int row = i / vpr, c = i - (i / vpr) * vpr;
      r0[j] = r1[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && row < nvalid) {
        const long long off = (long long)(pos0 + row);
        r0[j] = __ldg(reinterpret_cast<const uint4*>(src0 + off * ss0) + c);
        if (src1 != nullptr)
          r1[j] = __ldg(reinterpret_cast<const uint4*>(src1 + off * ss1) + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = base + j * kThreads + tid;
      if (i < total) {
        const int row = i / vpr, c = i - (i / vpr) * vpr;
        reinterpret_cast<uint4*>(dst0 + row * ld)[c] = r0[j];
        if (src1 != nullptr) reinterpret_cast<uint4*>(dst1 + row * ld)[c] = r1[j];
      }
    }
  }
}

// S[16 x 64] = Q[16 x D] K[64 x D]^T for the warp's 16 rows, float32.
__device__ __forceinline__ void scores(const bf16* qs, const bf16* ks,
                                       float* ss, int ld, int D, int lane) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBk / 16];
#pragma unroll
  for (int n = 0; n < kBk / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int k0 = 0; k0 < D; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, qs + k0, ld);
#pragma unroll
    for (int n = 0; n < kBk / 16; ++n) {
      // K^T as a column-major B operand: B[k][n] = K[n][k]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, ks + n * 16 * ld + k0, ld);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kBk / 16; ++n)
    wmma::store_matrix_sync(ss + n * 16, acc[n], kLdS, wmma::mem_row_major);
}

__device__ __forceinline__ void scores(const float* qs, const float* ks,
                                       float* ss, int ld, int D, int lane) {
  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float k0 = ks[lane * ld + d], k1 = ks[(lane + 32) * ld + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float qv = qs[r * ld + d];
      acc[r][0] = fmaf(qv, k0, acc[r][0]);
      acc[r][1] = fmaf(qv, k1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    ss[r * kLdS + lane] = acc[r][0];
    ss[r * kLdS + lane + 32] = acc[r][1];
  }
}

// O[16 x D] += P[16 x 64] V[64 x D] for the warp's 16 rows.
__device__ __forceinline__ void accumulate(const bf16* ps, const bf16* vs,
                                           float* os, int ld, int ldo, int D,
                                           int lane) {
  using namespace nvcuda;
  for (int n0 = 0; n0 < D; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::load_matrix_sync(o, os + n0, ldo, wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < kBk; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + k0, kLdP);
      wmma::load_matrix_sync(b, vs + k0 * ld + n0, ld);
      wmma::mma_sync(o, a, b, o);
    }
    wmma::store_matrix_sync(os + n0, o, ldo, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void accumulate(const float* ps, const float* vs,
                                           float* os, int ld, int ldo, int D,
                                           int lane) {
  constexpr int kCols = kMaxD / 32;  // output dims per lane
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = lane + 32 * j;
      acc[r][j] = d < D ? os[r * ldo + d] : 0.f;
    }
  for (int c = 0; c < kBk; ++c) {
    float vv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = lane + 32 * j;
      vv[j] = d < D ? vs[c * ld + d] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = ps[r * kLdP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = lane + 32 * j;
      if (d < D) os[r * ldo + d] = acc[r][j];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> L(a.D);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  T* ps = reinterpret_cast<T*>(smem + L.p);
  float* os = reinterpret_cast<float*>(smem + L.o);

  // the longest (last) query tiles are scheduled first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int S = a.S, D = a.D, ld = L.ld, ldo = L.ldo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kBq;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_tiles<T>(qs, qg, a.q_ss, nullptr, nullptr, 0, ld, q0, S - q0, D, tid);
  for (int i = tid; i < kBq * ldo; i += kThreads) os[i] = 0.f;

  // this warp's rows
  T* qw = qs + warp * kRows * ld;
  float* sw = ss + warp * kRows * kLdS;
  T* pw = ps + warp * kRows * kLdP;
  float* ow = os + warp * kRows * ldo;
  float m_r[kRows], l_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
  }

  // key tiles: from the first inside the window of the tile's first row to
  // the last at or below the diagonal of its last row
  const int q_last = min(q0 + kBq, S) - 1;
  const int k_end = a.causal ? q_last + 1 : S;
  int k_begin = 0;
  if (a.causal && q0 - a.window + 1 > 0) k_begin = q0 - a.window + 1;
  for (int t0 = (k_begin / kBk) * kBk; t0 < k_end; t0 += kBk) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tiles<T>(ks, kg, a.k_ss, vs, vg, a.v_ss, ld, t0, S - t0, D, tid);
    __syncthreads();

    scores(qw, ks, sw, ld, D, lane);
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp;
    // lane l holds key positions t0 + l and t0 + l + 32
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      const int kp0 = t0 + lane, kp1 = kp0 + 32;
      const bool ok0 = kp0 < S && (!a.causal ||
                                   (kp0 <= qpos && qpos - kp0 < a.window));
      const bool ok1 = kp1 < S && (!a.causal ||
                                   (kp1 <= qpos && qpos - kp1 < a.window));
      const float s0 = sw[r * kLdS + lane] * a.scale;
      const float s1 = sw[r * kLdS + lane + 32] * a.scale;
      const float mx = warp_max(fmaxf(ok0 ? s0 : kNegInf, ok1 ? s1 : kNegInf));
      const float m_new = fmaxf(m_r[r], mx);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * corr + warp_sum(p0 + p1);
      m_r[r] = m_new;
      pw[r * kLdP + lane] = from_f32<T>(p0);
      pw[r * kLdP + lane + 32] = from_f32<T>(p1);
      for (int d = lane; d < D; d += 32) ow[r * ldo + d] *= corr;
    }
    __syncwarp();

    accumulate(pw, vs, ow, ld, ldo, D, lane);
    __syncwarp();
  }

  // normalise, cast and store the warp's rows; the log-sum-exp beside them
  T* out = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) break;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    for (int d = lane; d < D; d += 32)
      out[qpos * a.o_ss + d] = from_f32<T>(ow[r * ldo + d] * inv);
    if (lane == 0)
      a.lse[((long long)b * a.H + h) * S + qpos] =
          l_r[r] > 0.f ? m_r[r] + logf(l_r[r]) : kNegInf;
  }
}

// dtype codes shared with the Python wrapper
enum { kF32 = 0, kBF16 = 1 };

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const Smem<T> L(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBq - 1) / kBq, a.H, B), block(kThreads);
  flash_fwd_kernel<T><<<grid, block, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out, float* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int B,
    int S, int H, int Hkv, int D, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv || D % 16 || D > kMaxD ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
         v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, S, H, Hkv, D,
         causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<bf16>(a, B, s);
  if (dtype == kF32) return launch<float>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
