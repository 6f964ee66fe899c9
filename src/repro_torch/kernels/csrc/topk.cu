// Top-k values and the top-k mask for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/sampling.py:
//   topk_values  (_topk_kernel at :98, wrapper at :122, pallas_call at :136)
//   topk_mask    (:149, the threshold mask over topk_values)
//
// What it computes, per row of float32 logits (B, V) and 0 < k <= V: the k
// largest values of the row in descending order, as a multiset (a value
// that occurs m times fills up to m places, as the TPU kernel retires only
// the first occurrence of each maximum), and optionally the mask
// where(x >= top[k - 1], x, -1e30), which keeps every entry tied with the
// k-th value.  It is a selection and does no arithmetic, so both outputs
// are bit-identical to the plain version (torch.sort, torch.where), up to
// the sign of a zero: -0.0 and +0.0 are one value here as in torch.sort,
// whose order between them is not fixed, and a place filled with a zero
// threshold holds +0.0.
//
// Bound on the H100: bytes.  The logits are read once (8 x 92544 float32 at
// the greedy kernel's shape, 3.0 MB, 0.9 us at 3.35 TB/s), the mask, where
// asked for, written once.  The design, simple first: one CTA of 1024
// threads per row runs an exact radix select on the values' order-
// preserving 32-bit keys, one byte per pass from the top:
//   * each pass reads the row, keeps the entries whose key matches the
//     bytes found so far, and counts their next byte in a 256-bin shared
//     histogram; the lanes of a warp that hold one byte add their count
//     with one atomic (__match_any_sync), so a crowded bin does not
//     serialise the warp;
//   * one warp scans the histogram from the top bin down (eight bins a
//     lane, then a shuffle scan over the lanes) for the bin holding the
//     k-th largest key; after four passes the key is exact;
//   * a fifth pass gathers the g < k values above that key into shared
//     memory, and each is placed by its rank (the count of larger keys,
//     ties by gather order); the k - g places left are the k-th value;
//   * the mask is written in the same pass as the gather.
// k up to 1024.
//
// Known limits, later work: the row is read five times (four from L2);
// B CTAs (8 at the engine's slot count) leave most SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 1024;
constexpr int kBins = 256;
constexpr float kNegInf = -1.0e30f;

// order-preserving key: a < b as floats (non-NaN) iff key(a) < key(b) as
// unsigned; -0.0 takes +0.0's key, so the two compare equal, as they do for
// torch.sort and the mask's x >= threshold
__device__ __forceinline__ uint32_t key_of(float x) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__global__ void __launch_bounds__(kThreads)
    topk_kernel(const float* logits, int V, int k, float* top,
                float* mask) {
  __shared__ unsigned hist[kBins];
  __shared__ float buf[kMaxK];
  __shared__ uint32_t s_prefix;
  __shared__ int s_rem, s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* x = logits + (long long)blockIdx.x * V;

  uint32_t prefix = 0, known = 0;   // the bytes of the k-th key found so far
  int rem = k;                      // its rank among the keys with prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < V; base += kThreads) {   // warp-uniform trips
      const int i = base + tid;
      int digit = kBins;                               // kBins: no count
      if (i < V) {
        const uint32_t kk = key_of(__ldg(x + i));
        if ((kk & known) == prefix) digit = (kk >> shift) & 0xff;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < kBins && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l - q, q = 0..7, from the top down
      unsigned c[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = hist[kBins - 1 - 8 * lane - q];
        sum += c[q];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= (unsigned)rem);
      if (lane == __ffs(hit) - 1) {     // the first lane reaching rem
        unsigned cum = incl - sum;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (cum + c[q] >= (unsigned)rem) {
            s_prefix = prefix |
                       ((uint32_t)(kBins - 1 - 8 * lane - q) << shift);
            s_rem = rem - (int)cum;
            break;
          }
          cum += c[q];
        }
      }
    }
    if (tid == 0) s_count = 0;
    __syncthreads();
    prefix = s_prefix;
    rem = s_rem;
    known |= 0xffu << shift;
    __syncthreads();        // every thread has read s_prefix and s_rem
  }

  // prefix is the k-th largest key; rem of its copies belong to the top k,
  // the g = k - rem keys above it are gathered
  const float thresh = value_of(prefix);
  float* mrow = mask ? mask + (long long)blockIdx.x * V : nullptr;
  for (int i = tid; i < V; i += kThreads) {
    const float xi = __ldg(x + i);
    if (key_of(xi) > prefix) buf[atomicAdd(&s_count, 1)] = xi;
    if (mrow) mrow[i] = xi >= thresh ? xi : kNegInf;
  }
  __syncthreads();
  const int g = s_count;
  float* trow = top + (long long)blockIdx.x * k;
  for (int j = tid; j < g; j += kThreads) {
    const uint32_t kj = key_of(buf[j]);
    int rank = 0;
    for (int i = 0; i < g; ++i) {
      const uint32_t ki = key_of(buf[i]);
      rank += ki > kj || (ki == kj && i < j);
    }
    trow[rank] = buf[j];
  }
  for (int j = g + tid; j < k; j += kThreads) trow[j] = thresh;
}

}  // namespace

extern "C" {

int topk_launch(const float* logits, float* top, float* mask, int B, int V,
                int k, void* stream) {
  if (B < 1 || V < 1 || k < 1 || k > V || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  topk_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, V, k, top, mask);
  return static_cast<int>(cudaGetLastError());
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
