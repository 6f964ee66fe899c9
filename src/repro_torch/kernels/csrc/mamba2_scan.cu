// Mamba2 (SSD) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/mamba2_scan.py:
//   mamba2_scan  (_ssd_kernel at :20, wrapper at :63, pallas_call at :80)
//
// What it computes, per batch row b and head h, from a zero (N, hd) state,
// with one decay w_t = exp(log_w_t) per (position, head):
//   y_t = r_t^T (w_t S_{t-1} + k_t v_t^T),
//   S_t = w_t S_{t-1} + k_t v_t^T,
// for r, k (B, S, H, N), v (B, S, H, hd) and log_w (B, S, H, 1); y (B, S,
// H, hd) in v's dtype and the final state (B, H, N, hd) float32.  It runs
// the chunked form of models/linear_scan.py (decay in the output) over
// 64-position chunks in float32.  With cl the *inclusive* running sum of
// log_w inside the chunk (the decay is in the output read, so position t
// already sees its own w_t, and the diagonal s = t belongs to A):
//   y       = exp(cl) * (r S) + A v,
//   A[t, s] = (r_t . k_s) exp(cl_t - cl_s)    for s <= t, else 0,
//   S      <- exp(cl_last) S + sum_s exp(cl_last - cl_s) k_s v_s^T.
// Only differences cl_t - cl_s <= 0, cl_last - cl_s <= 0 and cl_t <= 0
// are exponentiated, so strong decays (cl near -700 inside a chunk)
// underflow to 0 and never overflow; nothing is factored into exp(cl_t) *
// exp(-cl_s).  Because the decay is a scalar per head, A is the plain
// product R K^T times a (64, 64) matrix of decay weights.
//
// Bound on the H100, at zamba2-2.7b's longest prefill in the smoke (B 1,
// S 512, H 80, N = hd = 64, r/k bf16 broadcasts, v float32): the causal
// products (R K^T and A v over s <= t, r S and the state update) are about
// 1.0 GFLOP, 15 us at the 67 TFLOP/s float32 rate; the bytes (v and y
// float32, 10.5 MB each, the 1.3 MB state, r, k and log_w) are about 22.5
// MB, 6.7 us at 3.35 TB/s: operations bound.  The design, simple first:
//   * one CTA of 8 warps per (b, h, 32-column slice of v): 160 CTAs at
//     B 1, H 80, hd 64.  It walks the chunks in order (the loop takes the
//     place of the TPU's sequential grid axis) and keeps its (N, 32) slice
//     of the state in shared memory for the whole walk;
//   * r, k, v, log_w and y are read and written in their (B, S, H, D)
//     layouts through strides, and a head stride of 0 is allowed, so the
//     model's r and k (one (B, S, 1, N) slice broadcast over 80 heads) are
//     never copied.  Positions past S load as zeros (log_w 0 and k 0 leave
//     the state unchanged, as the TPU kernel's padding does);
//   * the running sum of log_w is one warp's shuffle scan;
//   * A in 4x4 register tiles, one per thread, tiles above the diagonal
//     skipped; y in 2x4 tiles (a row pair, four columns); the state update
//     in 1x4 tiles over the channels;
//   * the (position, channel) tiles have an odd row stride, N | 1, so the
//     column reads of A's tiles are nearly free of bank conflicts.
// N and hd up to 128; r and k float32 or bfloat16 (one dtype), v float32
// or bfloat16, log_w float32.
//
// Known limits, later work: CUDA cores only (R K^T, A v, r S and the state
// update are products a tensor-core kernel would take); R K^T is the same
// for every head of a row when r and k are broadcasts, and each of the 160
// CTAs recomputes it; loads are not overlapped with the chunk before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kC = 64;                 // positions per chunk
constexpr int kVs = 32;                // value columns per CTA
constexpr int kMaxD = 128;
constexpr int kLdA = kC + 1;           // row stride of A
constexpr int kTiles = kC / 4;         // 4x4 tiles per side of A

static_assert(kThreads == kTiles * kTiles, "A: one 4x4 tile per thread");
static_assert(kThreads == (kC / 2) * (kVs / 4), "y: row pairs x quads");

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

struct Args {
  const void* r;       // (B, S, H, N)
  const void* k;       // (B, S, H, N)
  const void* v;       // (B, S, H, hd)
  const float* lw;     // (B, S, H, 1), <= 0
  void* y;             // (B, S, H, hd), v's dtype
  float* state;        // (B, H, N, hd) contiguous
  long long r_sb, r_ss, r_sh;  // element strides (batch, position, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int S, H, N, hd;
};

inline size_t smem_floats(int N) {
  const int ldn = N | 1;
  return (size_t)2 * kC * ldn + (size_t)kC * kLdA + (size_t)kC * kVs +
         (size_t)N * kVs + 3 * kC;
}

template <typename TR, typename TV>
__global__ void __launch_bounds__(kThreads)
    mamba2_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int N = a.N, ldn = a.N | 1, S = a.S;
  // 2 kC ldn + kC kLdA = kC (2 ldn + kLdA) is a multiple of kC floats, so
  // vs and Ss below are 16-byte aligned for their float4 reads
  float* rs = sm;                  // (kC, ldn): r of the chunk
  float* ks = rs + kC * ldn;       // (kC, ldn): k
  float* As = ks + kC * ldn;       // (kC, kLdA): A
  float* vs = As + kC * kLdA;      // (kC, kVs): this CTA's columns of v
  float* Ss = vs + kC * kVs;       // (N, kVs): its columns of the state
  float* cl = Ss + N * kVs;        // (kC,): inclusive running sum of log_w
  float* er = cl + kC;             // (kC,): exp(cl_t)
  float* dk = er + kC;             // (kC,): exp(cl_last - cl_s)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int j0 = blockIdx.y * kVs;
  const int nv = min(kVs, a.hd - j0);          // live columns of the slice
  const TR* r = static_cast<const TR*>(a.r) + b * a.r_sb + h * a.r_sh;
  const TR* k = static_cast<const TR*>(a.k) + b * a.k_sb + h * a.k_sh;
  const TV* v = static_cast<const TV*>(a.v) + b * a.v_sb + h * a.v_sh + j0;
  const float* lw = a.lw + b * a.w_sb + h * a.w_sh;
  TV* y = static_cast<TV*>(a.y) + b * a.y_sb + h * a.y_sh + j0;

  for (int i = tid; i < N * kVs; i += kThreads) Ss[i] = 0.f;

  const int ti = tid / kTiles, si = tid % kTiles;        // A's 4x4 tile
  const int t2 = 2 * (tid >> 3), jq = 4 * (tid & 7);     // y's 2x4 tile
  const int n_chunks = (S + kC - 1) / kC;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const long long c0 = (long long)ci * kC;

    // 1. the chunk into shared memory as float32, zeros past S; every
    //    load from a clamped address, the zero a select after it
    for (int i = tid; i < kC * N; i += kThreads) {
      const int t = i / N, d = i % N;
      const bool ok = c0 + t < S;
      const long long pc = ok ? c0 + t : (long long)S - 1;
      const float rv = to_f32(r[pc * a.r_ss + d]);
      const float kv = to_f32(k[pc * a.k_ss + d]);
      rs[t * ldn + d] = ok ? rv : 0.f;
      ks[t * ldn + d] = ok ? kv : 0.f;
    }
    for (int i = tid; i < kC * kVs; i += kThreads) {
      const int t = i / kVs, j = i % kVs;
      const bool ok = c0 + t < S;
      const long long pc = ok ? c0 + t : (long long)S - 1;
      const float vv = to_f32(v[pc * a.v_ss + min(j, nv - 1)]);
      vs[i] = ok && j < nv ? vv : 0.f;
    }
    if (tid < 32) {   // inclusive scan of log_w, two positions a lane
      const long long p0 = c0 + 2 * tid, p1 = p0 + 1;
      const float w0 = __ldg(lw + min(p0, (long long)S - 1) * a.w_ss);
      const float w1 = __ldg(lw + min(p1, (long long)S - 1) * a.w_ss);
      const float x0 = p0 < S ? w0 : 0.f, x1 = p1 < S ? w1 : 0.f;
      float sc = x0 + x1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, sc, o);
        if (tid >= o) sc += up;
      }
      cl[2 * tid] = sc - x1;
      cl[2 * tid + 1] = sc;
    }
    __syncthreads();

    // 2. the decay factors of the read and of the state update, and A
    if (tid < kC) {
      er[tid] = expf(cl[tid]);
      dk[tid] = expf(cl[kC - 1] - cl[tid]);
    }
    if (si <= ti) {
      const int t0 = 4 * ti, s0 = 4 * si;
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < N; ++d) {
        float rv[4], kv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          rv[x] = rs[(t0 + x) * ldn + d];
          kv[x] = ks[(s0 + x) * ldn + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += rv[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + i, s = s0 + j;
          As[t * kLdA + s] = s <= t ? acc[i][j] * expf(cl[t] - cl[s]) : 0.f;
        }
    }
    __syncthreads();

    // 3. y = exp(cl) * (r S) + A v for rows t2, t2 + 1 (one diagonal tile
    //    of A holds both, so A[t2, t2 + 1] is the 0 written above)
    {
      float acc[2][4] = {};
#pragma unroll 4
      for (int d = 0; d < N; ++d) {
        const float4 s4 = *reinterpret_cast<const float4*>(Ss + d * kVs + jq);
        const float r0 = rs[t2 * ldn + d], r1 = rs[(t2 + 1) * ldn + d];
        acc[0][0] += r0 * s4.x; acc[0][1] += r0 * s4.y;
        acc[0][2] += r0 * s4.z; acc[0][3] += r0 * s4.w;
        acc[1][0] += r1 * s4.x; acc[1][1] += r1 * s4.y;
        acc[1][2] += r1 * s4.z; acc[1][3] += r1 * s4.w;
      }
      const float e0 = er[t2], e1 = er[t2 + 1];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc[0][x] *= e0;
        acc[1][x] *= e1;
      }
#pragma unroll 4
      for (int s = 0; s <= t2 + 1; ++s) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + s * kVs + jq);
        const float a0 = As[t2 * kLdA + s], a1 = As[(t2 + 1) * kLdA + s];
        acc[0][0] += a0 * v4.x; acc[0][1] += a0 * v4.y;
        acc[0][2] += a0 * v4.z; acc[0][3] += a0 * v4.w;
        acc[1][0] += a1 * v4.x; acc[1][1] += a1 * v4.y;
        acc[1][2] += a1 * v4.z; acc[1][3] += a1 * v4.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long pos = c0 + t2 + i;
        if (pos >= S) break;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (jq + x < nv) y[pos * a.y_ss + jq + x] = from_f32<TV>(acc[i][x]);
      }
    }
    __syncthreads();   // every read of the state precedes its update

    // 4. S <- exp(cl_last) S + sum_s exp(cl_last - cl_s) k_s v_s^T
    {
      const float eL = er[kC - 1];
      for (int n = tid >> 3; n < N; n += kThreads / 8) {
        const float4 p = *reinterpret_cast<const float4*>(Ss + n * kVs + jq);
        float acc[4] = {eL * p.x, eL * p.y, eL * p.z, eL * p.w};
#pragma unroll 4
        for (int s = 0; s < kC; ++s) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vs + s * kVs + jq);
          const float kd = ks[s * ldn + n] * dk[s];
          acc[0] += kd * v4.x; acc[1] += kd * v4.y;
          acc[2] += kd * v4.z; acc[3] += kd * v4.w;
        }
        *reinterpret_cast<float4*>(Ss + n * kVs + jq) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    __syncthreads();   // the next chunk's stores overwrite this one's tiles
  }

  float* st = a.state + ((long long)b * a.H + h) * N * a.hd + j0;
  for (int i = tid; i < N * kVs; i += kThreads) {
    const int d = i / kVs, j = i % kVs;
    if (j < nv) st[(long long)d * a.hd + j] = Ss[i];
  }
}

// dtype codes shared with the Python wrapper
enum { kF32 = 0, kBF16 = 1 };

template <typename TR, typename TV>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_scan_kernel<TR, TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.hd + kVs - 1) / kVs), block(kThreads);
  mamba2_scan_kernel<TR, TV><<<grid, block, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR>
int launch(const Args& a, int B, int v_dtype, cudaStream_t stream) {
  if (v_dtype == kF32) return launch<TR, float>(a, B, stream);
  if (v_dtype == kBF16) return launch<TR, bf16>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int mamba2_scan_forward(const void* r, const void* k, const void* v,
                        const float* lw, void* y, float* state,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        long long y_sb, long long y_ss, long long y_sh,
                        int B, int S, int H, int N, int hd, int rk_dtype,
                        int v_dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || N < 1 || hd < 1 || N > kMaxD ||
      hd > kMaxD || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, lw, y, state, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh,
         v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, y_sb, y_ss, y_sh, S, H, N, hd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rk_dtype == kBF16) return launch<bf16>(a, B, v_dtype, s);
  if (rk_dtype == kF32) return launch<float>(a, B, v_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mamba2_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
