// Fused greedy sampling epilogue for Hopper (sm_90a): argmax + logprob,
// each row split over a thread-block cluster.
//
// Replaces the TPU kernel in src/repro/kernels/sampling.py:
//   greedy_sample  (_greedy_kernel at :34, wrapper at :64, pallas_call at
//   :78)
//
// What it computes, per row of float32 logits (B, V): the first-occurrence
// argmax token and its log-probability logit[argmax] - logsumexp(row)
// = -log(sum exp(x - max)), clamped as -log(max(l, 1e-30)).
//
// Bound on the H100: bytes.  Each logit is read once and used for a
// compare, an exponential and an add, so the B * V * 4 bytes of logits set
// the time (2.96 MB at the engine's 8 rows of internlm2's 92544, 0.9 us at
// 3.35 TB/s); nothing is written back but (token, logprob).  The design:
//   * a cluster of C CTAs per row (the caller picks C from B so that B x C
//     fills the SMs: 16, a non-portable cluster size, at 8 rows, where
//     chip_smoke.py times 8 beside it), each CTA of 16 warps reducing one
//     slice of the row (a multiple of 4 entries) with 16-byte loads,
//     four in flight a thread (the whole slice at 8 x 92544), where the
//     rows allow (element loads otherwise).  Each thread keeps a running
//     (max, first index of the max, sum of exp(x - max)); the exponentials
//     are one MUFU.EX2 each (ex2.approx.ftz: expf's denormal fix-up
//     serialises them);
//   * warp shuffles, then shared memory across the warps, merge the CTA's
//     threads; after one cluster barrier the first warp of CTA 0 reads the
//     cluster's states through distributed shared memory, one a lane, and
//     merges them; a second barrier keeps every CTA alive until it has.
//     No global scratch and no second launch.  At equal maxima every merge
//     keeps the smaller index, so the first-occurrence rule of the TPU
//     kernel's strict `>` across vocabulary blocks holds across threads,
//     warps and the slices' edges.
// The launch and the two cluster barriers set a floor of a few
// microseconds, far above the bound.  Nothing is sized by V: shared memory
// holds one state a warp and one a CTA, indices are 32-bit (V < 2^31) and
// a row's offset 64-bit, so gemma3-4b's 262144 entries (16384 a CTA at 16
// CTAs, 8 loads of 16 bytes a thread) take the same code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // loads per thread in flight at once
constexpr int kMaxCluster = 16;     // the non-portable cluster size limit
constexpr int kNoIndex = 0x7fffffff;
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct State {
  float m;  // running max
  int i;    // first index of the max
  float l;  // sum of exp(x - m)
};

// e^x for x <= 0 as one MUFU.EX2 (relative error about 2^-22)
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

__device__ __forceinline__ State merge(State a, State b) {
  const float m = fmaxf(a.m, b.m);
  State r;
  r.m = m;
  r.l = a.l * exp_ftz(a.m - m) + b.l * exp_ftz(b.m - m);
  r.i = a.m > b.m ? a.i : (b.m > a.m ? b.i : min(a.i, b.i));
  return r;
}

__device__ __forceinline__ State warp_merge(State s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    State t;
    t.m = __shfl_xor_sync(0xffffffffu, s.m, o);
    t.i = __shfl_xor_sync(0xffffffffu, s.i, o);
    t.l = __shfl_xor_sync(0xffffffffu, s.l, o);
    s = merge(s, t);
  }
  return s;
}

// entries idx .. idx + 3 into the running state; a thread's entries come
// in increasing order, so the strict > keeps the first occurrence
__device__ __forceinline__ void add4(State& s, float4 q, int idx) {
  const float mx = fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w));
  if (mx > s.m) {
    s.l *= exp_ftz(s.m - mx);
    s.m = mx;
    s.i = idx + (q.x == mx ? 0 : (q.y == mx ? 1 : (q.z == mx ? 2 : 3)));
  }
  s.l += (exp_ftz(q.x - s.m) + exp_ftz(q.y - s.m)) +
         (exp_ftz(q.z - s.m) + exp_ftz(q.w - s.m));
}

__device__ __forceinline__ void add1(State& s, float x, int idx) {
  if (x > s.m) {
    s.l = s.l * exp_ftz(s.m - x) + 1.f;
    s.m = x;
    s.i = idx;
  } else {
    s.l += exp_ftz(x - s.m);
  }
}

// grid (cluster, B), one cluster a row; CTA `rank` reduces entries
// [rank slice, rank slice + slice) of it
__global__ void __launch_bounds__(kThreads)
    greedy_kernel(const float* logits, int32_t* tokens, float* logprobs,
                  int V, int slice, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ State part[kWarps];
  __shared__ State cta;               // read by CTA 0 through DSMEM
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int n_ctas = (int)cluster.num_blocks();
  const int row = blockIdx.y;
  const int lo = rank * slice;
  const int n = max(0, min(slice, V - lo));
  const float* x = logits + (long long)row * V + lo;

  State s{kNegInf, kNoIndex, 0.f};
  if (vec) {     // n and the slice's start are multiples of 4
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = n / 4;
    for (int base = tid; base < n4; base += kThreads * kUnroll) {
      float4 q[kUnroll];        // independent loads, in flight together
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        q[u] = j < n4 ? __ldg(x4 + j)
                      : make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        if (j >= n4) break;
        add4(s, q[u], lo + 4 * j);
      }
    }
  } else {
    for (int base = tid; base < n; base += kThreads * kUnroll) {
      float q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        q[u] = j < n ? __ldg(x + j) : kNegInf;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        if (j >= n) break;
        add1(s, q[u], lo + j);
      }
    }
  }
  s = warp_merge(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? part[lane] : State{kNegInf, kNoIndex, 0.f};
    s = warp_merge(s);
    if (lane == 0) cta = s;
  }
  cluster.sync();            // every CTA's state is in its shared memory
  if (rank == 0 && warp == 0) {
    State t = lane < n_ctas ? *cluster.map_shared_rank(&cta, lane)
                            : State{kNegInf, kNoIndex, 0.f};
    t = warp_merge(t);
    if (lane == 0) {
      tokens[row] = t.i == kNoIndex ? 0 : t.i;
      logprobs[row] = -logf(fmaxf(t.l, 1e-30f));
    }
  }
  cluster.sync();            // no CTA leaves while CTA 0 reads its state
}

}  // namespace

extern "C" {

// cluster: CTAs per row, a power of two up to 16; slice: entries of a row
// each CTA reduces, a multiple of 4 with cluster * slice >= V
int greedy_sample_launch(const float* logits, int32_t* tokens,
                         float* logprobs, int B, int V, int cluster,
                         int slice, void* stream) {
  if (B < 1 || V < 1 || B > 65535 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || slice < 1 || slice % 4 != 0 ||
      (long long)slice * cluster < V)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > 8) {
    static const cudaError_t allowed = cudaFuncSetAttribute(
        greedy_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
  }
  const int vec =
      V % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, greedy_kernel, logits,
                                             tokens, logprobs, V, slice,
                                             vec));
}

const char* greedy_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
