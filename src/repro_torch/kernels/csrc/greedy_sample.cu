// Fused greedy sampling epilogue for Hopper (sm_90a): argmax + logprob.
//
// Replaces the TPU kernel in src/repro/kernels/sampling.py:
//   greedy_sample  (_greedy_kernel, pallas_call at :78)
//
// What it computes, per row of float32 logits (B, V): the first-occurrence
// argmax token and its log-probability logit[argmax] - logsumexp(row)
// = -log(sum exp(x - max)), clamped as -log(max(l, 1e-30)).
//
// Bound on the H100: bytes.  Each logit is read once and used for a compare,
// an exp and an add, so the B * V * 4 bytes of logits set the time.  The
// design reads them in one pass with nothing written back but (token,
// logprob): one CTA per row; each thread runs a strided (max, first index,
// rescaled sum) over the vocabulary, coalesced across the warp, and a tree
// reduction (warp shuffles, then shared memory across warps) combines the
// threads.  At equal maxima the merge keeps the smaller index, which
// reproduces the first-occurrence rule of the TPU kernel's strict `>`
// across vocabulary blocks.
//
// Known limit: B CTAs (8 at the engine's slot count) leave most SMs idle; a
// multi-CTA split of each row with a merge pass is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;    // loads per thread in flight at once
constexpr int kNoIndex = 0x7fffffff;
constexpr float kNegInf = -1.0e30f;

struct State {
  float m;  // running max
  int i;    // first index of the max
  float l;  // sum of exp(x - m)
};

__device__ __forceinline__ State merge(State a, State b) {
  const float m = fmaxf(a.m, b.m);
  State r;
  r.m = m;
  r.l = a.l * expf(a.m - m) + b.l * expf(b.m - m);
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

__global__ void __launch_bounds__(kThreads)
    greedy_kernel(const float* logits, int32_t* tokens, float* logprobs,
                  int V) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* x = logits + (long long)row * V;

  State s{kNegInf, kNoIndex, 0.f};
  for (int base = tid; base < V; base += kThreads * kUnroll) {
    float xs[kUnroll];  // independent loads, in flight together
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      xs[u] = i < V ? __ldg(x + i) : kNegInf;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i >= V) break;
      if (xs[u] > s.m) {  // strict: a thread visits its indices in order
        s.l = s.l * expf(s.m - xs[u]) + 1.f;
        s.m = xs[u];
        s.i = i;
      } else {
        s.l += expf(xs[u] - s.m);
      }
    }
  }
  s = warp_merge(s);

  __shared__ State part[kWarps];
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? part[lane] : State{kNegInf, kNoIndex, 0.f};
    s = warp_merge(s);
    if (lane == 0) {
      tokens[row] = s.i == kNoIndex ? 0 : s.i;
      logprobs[row] = -logf(fmaxf(s.l, 1e-30f));
    }
  }
}

}  // namespace

extern "C" {

int greedy_sample_launch(const float* logits, int32_t* tokens,
                         float* logprobs, int B, int V, void* stream) {
  if (B < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  greedy_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, tokens, logprobs, V);
  return static_cast<int>(cudaGetLastError());
}

const char* greedy_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
