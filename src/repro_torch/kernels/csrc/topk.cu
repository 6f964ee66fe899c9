// Top-k values and the top-k mask for Hopper (sm_90a): one thread-block
// cluster per row.
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
// asked for, written once.  The design: a cluster of kCluster CTAs per row
// (64 CTAs at B 8), each holding one slice of the row (a multiple of 4
// entries, 11568 at V 92544) in shared memory from its one read of device
// memory to the end, runs an exact radix select on the values' order-
// preserving 32-bit keys, one byte per pass from the top:
//   * each CTA counts the next byte of its slice's keys that match the
//     bytes found so far in a 256-bin shared histogram (the first pass while
//     it loads the slice); the lanes of a warp that hold one byte add their
//     count with one atomic (__match_any_sync);
//   * after a cluster barrier every CTA sums the cluster's histograms
//     through distributed shared memory and scans the sum from the top bin
//     down for the bin holding the k-th largest key, so every CTA picks the
//     same bin; the histograms are double-buffered, one barrier a pass;
//   * after four passes the key is exact; each CTA gathers its values above
//     it, the cluster's g < k of them are copied into every CTA in (CTA,
//     gather) order, and each CTA places its own by rank (the count of
//     larger keys, ties by that order); the k - g places left are the k-th
//     value;
//   * each CTA writes the mask over its slice in the gather pass.
// k up to 1024.  A slice that does not fit in shared memory (V above about
// 430 K) is read from device memory in every pass instead.
//
// Known limits, later work: five cluster barriers in a row set the time
// for short rows; 8 CTAs per row (16 with a non-portable cluster size would
// halve each slice).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kMaxK = 1024;
constexpr int kBins = 256;
constexpr float kNegInf = -1.0e30f;
constexpr int kMaxSliceBytes = 200 * 1024;   // kept on chip up to this

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

// the entries' count of the byte at ``shift`` of each key whose bytes above
// it equal ``prefix`` (``known`` masks them); warp-uniform calls
__device__ __forceinline__ void tally(unsigned* hist, float x, bool ok,
                                      uint32_t prefix, uint32_t known,
                                      int shift, int lane) {
  int digit = kBins;                                   // kBins: no count
  if (ok) {
    const uint32_t kk = key_of(x);
    if ((kk & known) == prefix) digit = (kk >> shift) & 0xff;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, digit);
  if (digit < kBins && lane == __ffs(peers) - 1)
    atomicAdd(&hist[digit], __popc(peers));
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    topk_kernel(const float* logits, int V, int k, int slice, int keep,
                int vec, float* top, float* mask) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned hist[2][kBins];
  __shared__ unsigned tot[kBins];
  __shared__ float cand[kMaxK];       // this CTA's values above the key
  __shared__ float all[kMaxK];        // the cluster's, in (CTA, gather) order
  __shared__ uint32_t s_prefix;
  __shared__ int s_rem, s_count;
  extern __shared__ __align__(16) float xs[];   // the slice, when kept

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.y;
  const int lo = rank * slice;
  const int n = max(0, min(slice, V - lo));
  const float* x = logits + (long long)row * V + lo;
  const float* src = keep ? xs : x;

  for (int i = tid; i < 2 * kBins; i += kThreads) (&hist[0][0])[i] = 0;
  if (tid == 0) s_count = 0;
  __syncthreads();

  // pass 0 while loading: count the top byte, keep the slice
  if (vec) {     // n and the slice's start are multiples of 4
    for (int base = 0; base < n; base += 4 * kThreads) {
      const int i = base + 4 * tid;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n) {
        q = __ldg(reinterpret_cast<const float4*>(x + i));
        if (keep) *reinterpret_cast<float4*>(xs + i) = q;
      }
      tally(hist[0], q.x, i < n, 0, 0, 24, lane);
      tally(hist[0], q.y, i < n, 0, 0, 24, lane);
      tally(hist[0], q.z, i < n, 0, 0, 24, lane);
      tally(hist[0], q.w, i < n, 0, 0, 24, lane);
    }
  } else {
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      float xi = 0.f;
      if (i < n) {
        xi = __ldg(x + i);
        if (keep) xs[i] = xi;
      }
      tally(hist[0], xi, i < n, 0, 0, 24, lane);
    }
  }

  uint32_t prefix = 0, known = 0;   // the bytes of the k-th key found so far
  int rem = k;                      // its rank among the keys with prefix
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    unsigned* h = hist[pass & 1];
    if (pass > 0) {
      if (vec) {
        for (int base = 0; base < n; base += 4 * kThreads) {
          const int i = base + 4 * tid;
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n) q = *reinterpret_cast<const float4*>(src + i);
          tally(h, q.x, i < n, prefix, known, shift, lane);
          tally(h, q.y, i < n, prefix, known, shift, lane);
          tally(h, q.z, i < n, prefix, known, shift, lane);
          tally(h, q.w, i < n, prefix, known, shift, lane);
        }
      } else {
        for (int base = 0; base < n; base += kThreads) {
          const int i = base + tid;
          tally(h, i < n ? src[i] : 0.f, i < n, prefix, known, shift, lane);
        }
      }
    }
    // every CTA's histogram of this pass is complete; the other buffer was
    // read by every CTA before it arrived here, so it may be cleared
    cluster.sync();
    for (int b = tid; b < kBins; b += kThreads) {
      unsigned s = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(h, r)[b];
      tot[b] = s;
      hist[(pass + 1) & 1][b] = 0;
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l - q, q = 0..7, from the top down
      unsigned c[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = tot[kBins - 1 - 8 * lane - q];
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
    __syncthreads();
    prefix = s_prefix;
    rem = s_rem;
    known |= 0xffu << shift;
  }

  // prefix is the k-th largest key; rem of its copies belong to the top k,
  // the g = k - rem keys above it are gathered
  const float thresh = value_of(prefix);
  float* mrow = mask ? mask + (long long)row * V + lo : nullptr;
  if (vec) {
    for (int i = 4 * tid; i < n; i += 4 * kThreads) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (key_of(e[j]) > prefix) cand[atomicAdd(&s_count, 1)] = e[j];
      if (mrow)
        *reinterpret_cast<float4*>(mrow + i) = make_float4(
            q.x >= thresh ? q.x : kNegInf, q.y >= thresh ? q.y : kNegInf,
            q.z >= thresh ? q.z : kNegInf, q.w >= thresh ? q.w : kNegInf);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      const float xi = src[i];
      if (key_of(xi) > prefix) cand[atomicAdd(&s_count, 1)] = xi;
      if (mrow) mrow[i] = xi >= thresh ? xi : kNegInf;
    }
  }
  cluster.sync();      // every CTA's candidates and count are final

  int off = 0, g = 0, mine = 0;
  for (int r = 0; r < kCluster; ++r) {
    const int cr = *cluster.map_shared_rank(&s_count, r);
    if (r < rank) off += cr;
    if (r == rank) mine = cr;
    const float* rc = cluster.map_shared_rank(cand, r);
    for (int j = tid; j < cr; j += kThreads) all[g + j] = rc[j];
    g += cr;
  }
  __syncthreads();
  float* trow = top + (long long)row * k;
  for (int j = off + tid; j < off + mine; j += kThreads) {
    const uint32_t kj = key_of(all[j]);
    int pos = 0;
    for (int i = 0; i < g; ++i) {
      const uint32_t ki = key_of(all[i]);
      pos += ki > kj || (ki == kj && i < j);
    }
    trow[pos] = all[j];
  }
  for (int j = g + rank * kThreads + tid; j < k; j += kCluster * kThreads)
    trow[j] = thresh;
  cluster.sync();      // no CTA leaves while another reads its candidates
}

}  // namespace

extern "C" {

int topk_launch(const float* logits, float* top, float* mask, int B, int V,
                int k, void* stream) {
  if (B < 1 || B > 65535 || V < 1 || k < 1 || k > V || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  // slices of a multiple of 4 entries, so 16-byte loads stay aligned
  const int slice = ((V + kCluster - 1) / kCluster + 3) / 4 * 4;
  const int vec = V % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                  (!mask || reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  const int keep = (long long)slice * 4 <= kMaxSliceBytes;
  const int bytes = keep ? slice * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_kernel<<<dim3(kCluster, B), kThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(
      logits, V, k, slice, keep, vec, top, mask);
  return static_cast<int>(cudaGetLastError());
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
