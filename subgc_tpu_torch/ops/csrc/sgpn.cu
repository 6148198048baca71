// The sGPN test path's two dense intermediates as kernels that read each
// sub-graph straight from its node list (models/gpn.py::gpn_test_forward's
// read-out max, ::subgraph_nms's keep set).
//
// They replace no TPU kernel: the JAX package leaves both to XLA, and the
// port first wrote them as torch ops over dense intermediates, at the
// benchmark's test shapes (16 images x 1,024 sub-graphs x 37 nodes, L =
// 1,024):
// * the read-out max as a masked broadcast, x[b, n, :] + (mem[b, s, n] - 1)
//   * 1e30 over [B, S, n_obj, L] (2.48 GB of float32 written by a
//   broadcasting kernel and read back by amax, ~3.5 ms a dispatch, for a
//   67 MB result);
// * the NMS as a Jacobi fixpoint over [B, S, S] IoU and suppression
//   matrices (64 MB each), one batched GEMV a round and a host stop test
//   a round (8-18 rounds a dispatch, each a sync).
//
// Both kernels take a sub-graph's node set as one 64-bit word (at most 64
// nodes an image; the cells have 37): bit i is set where some slot n has
// att_mask != 0 and obj_ind == i, 0 <= i < n_obj (an index outside the
// image gives no member, as the one-hot comparison of
// models/encoder.py::one_hot gives a zero row).  Masks are {0, 1}.
//
// readout_max_kernel.  out[b, s, c] = max over n < n_obj of
//   x[b, n, c] + (member(s, n) ? 0.0f : -1e30f),
// the torch path's arithmetic term by term ((mem - 1) * 1e30 is 0.0f or
// -1e30f in float32; -0.0f + 0.0f is +0.0f as there), NaN where any term
// is NaN (max.NaN, as amax propagates it).  A max does not depend on its
// order, so the result is the torch path's bit for bit.  What bounds it:
// its bytes are x (2.4 MB), the node lists (7.3 MB) and the output (67 MB),
// ~0.023 ms at 3.35 TB/s; its issue slots are ~4 instructions a term,
// 16,384 x 1,024 x 40 terms (n_obj rounded up to 8), ~0.09 ms at the
// H100's 29.6 T lane instructions a second.  Taking the max over the
// members alone would save most of them but reproduces the broadcast only
// where every |x| < 2^75; the terms are kept.  Design: a block takes 128
// columns (a thread each) of 32 sub-graphs of one image; each thread
// holds its column of the image's node rows in registers (padded to a
// multiple of 8 with -inf, which never wins), the block builds the 32
// node words in shared memory from coalesced reads of the node lists, and
// each thread writes its column of the 32 rows (coalesced, into the max
// half of the read-out: rows ld floats apart).
//
// subgraph_nms_kernel.  One block an image.  In score order (the caller's
// stable sort) sub-graph i is kept iff it is valid and no kept j < i has
// IoU(j, i) > thres, where IoU = popc(a & b) / max(popc(a) + popc(b) -
// popc(a & b), 1) divided in float32 round-to-nearest (__fdiv_rn; the
// integers are exact in float32) and thres is the caller's threshold
// rounded to float32, which is the torch path's IoU and comparison.  That
// keep set is the unique fixpoint the torch path iterates to; the sweep
// stops after max_keep keeps, since full NMS truncated to max_keep is its
// greedy prefix.  What bounds it: its bytes (~7.6 MB over 16 images,
// ~2 us) are not the limit; the sweep is sequential in i within an image,
// so a block pays one barrier a keep (10 keeps an image at the Kar cell's
// keep 10, ~300 at the M-RNN cell's keep 1,000 and threshold 0.55) and a
// shared-memory read a sub-graph it passes over.  Design: each warp builds
// node words of whole sub-graphs (lanes over slots, OR-reduced by
// shuffles) into shared memory in score order, with an alive flag (valid,
// not yet suppressed); then every thread walks i together, and at a keep
// the block tests all later alive j at once and clears those above the
// threshold.  Between two keeps no flag changes, so only a keep needs a
// barrier.  8 bytes of node word and a flag a sub-graph: 9 KB at 1,024.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNonMember = -1e30f;   // (0 - 1) * 1e30 in float32
constexpr int kCols = 128;             // read-out columns a block
constexpr int kTile = 32;              // read-out sub-graphs a block
constexpr int kNmsWarps = 16;
constexpr size_t kMaxSmem = 232448;    // a block's shared memory on an H100

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int NMAX>
__global__ void __launch_bounds__(kCols)
readout_max_kernel(const float* __restrict__ x,
                   const int64_t* __restrict__ obj_ind,
                   const float* __restrict__ att_mask,
                   float* __restrict__ out, int S, int N, int n_obj, int L,
                   long long ld) {
  __shared__ unsigned long long members[kTile];
  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * kTile;
  const int c = blockIdx.x * kCols + t;
  const int tile = min(kTile, S - s0);
  if (t < kTile) members[t] = 0ull;

  float xv[NMAX];
  const float* xb = x + (size_t)b * n_obj * L + c;
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    xv[j] = (j < n_obj && c < L) ? __ldg(xb + (size_t)j * L) : -INFINITY;
  __syncthreads();

  const size_t base = ((size_t)b * S + s0) * N;
  for (int e = t; e < tile * N; e += kCols) {
    if (att_mask[base + e] != 0.f) {
      const long long i = obj_ind[base + e];
      if (i >= 0 && i < n_obj) atomicOr(&members[e / N], 1ull << i);
    }
  }
  __syncthreads();
  if (c >= L) return;

  float* o = out + ((size_t)b * S + s0) * ld + c;
  for (int s = 0; s < tile; ++s) {
    const unsigned long long m = members[s];
    float acc = -INFINITY;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      acc = max_nan(acc, xv[j] + (((m >> j) & 1ull) ? 0.f : kNonMember));
    o[(size_t)s * ld] = acc;
  }
}

__global__ void __launch_bounds__(kNmsWarps * 32)
subgraph_nms_kernel(const int64_t* __restrict__ order,
                    const int64_t* __restrict__ obj_ind,
                    const float* __restrict__ att_mask,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int S, int N, int n_obj,
                    float thres, int max_keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* members = smem;                        // [S]
  uint8_t* alive = reinterpret_cast<uint8_t*>(smem + S);     // [S]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const size_t img = (size_t)b * S;

  for (int p = threadIdx.x >> 5; p < S; p += warps) {
    const long long s = order[img + p];
    const size_t row = (img + s) * N;
    unsigned long long m = 0ull;
    for (int n = lane; n < N; n += 32) {
      if (att_mask[row + n] != 0.f) {
        const long long i = obj_ind[row + n];
        if (i >= 0 && i < n_obj) m |= 1ull << i;
      }
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) m |= __shfl_xor_sync(0xffffffffu, m, d);
    if (lane == 0) {
      members[p] = m;
      alive[p] = valid[img + s] != 0;
    }
  }
  for (int p = threadIdx.x; p < S; p += blockDim.x) keep[img + p] = 0;
  __syncthreads();

  int kept = 0;
  for (int i = 0; i < S && kept < max_keep; ++i) {
    if (!alive[i]) continue;            // the same flag for every thread
    if (threadIdx.x == 0) keep[img + i] = 1;
    if (++kept == max_keep) break;
    const unsigned long long a = members[i];
    const int na = __popcll(a);
    for (int j = i + 1 + threadIdx.x; j < S; j += blockDim.x) {
      if (!alive[j]) continue;
      const unsigned long long m = members[j];
      const int inter = __popcll(a & m);
      const float iou = __fdiv_rn(
          (float)inter, fmaxf((float)(na + __popcll(m) - inter), 1.f));
      if (iou > thres) alive[j] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

// out[b, s, :L] (rows ld floats apart, b-major) = the read-out max of
// x [B, n_obj, L] over sub-graph s's node set, from obj_ind / att_mask
// [B, S, N], on the given stream of the current device.  Returns 0 or a
// cudaError_t.
extern "C" int subgc_readout_max_f32(const float* x, const int64_t* obj_ind,
                                     const float* att_mask, float* out,
                                     int B, int S, int N, int n_obj, int L,
                                     long long ld, void* stream) {
  if (B <= 0 || S <= 0 || L <= 0) return (int)cudaSuccess;
  if (n_obj < 1 || n_obj > 64 || N < 0 || ld < L)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kCols - 1) / kCols, (S + kTile - 1) / kTile, B);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SUBGC_READOUT(NMAX)                                                  \
  case NMAX / 8:                                                             \
    readout_max_kernel<NMAX><<<grid, kCols, 0, st>>>(x, obj_ind, att_mask,   \
                                                     out, S, N, n_obj, L,    \
                                                     ld);                    \
    break;
  switch ((n_obj + 7) / 8) {
    SUBGC_READOUT(8) SUBGC_READOUT(16) SUBGC_READOUT(24) SUBGC_READOUT(32)
    SUBGC_READOUT(40) SUBGC_READOUT(48) SUBGC_READOUT(56) SUBGC_READOUT(64)
  }
#undef SUBGC_READOUT
  return (int)cudaGetLastError();
}

// keep [B, S] (0/1, score order) = the greedy NMS keep set of each image,
// at most max_keep a row: order [B, S] the stable score order, obj_ind /
// att_mask [B, S, N] and valid [B, S] (0/1) in the original order, on the
// given stream of the current device.  Returns 0 or a cudaError_t.
extern "C" int subgc_subgraph_nms(const int64_t* order, const int64_t* obj_ind,
                                  const float* att_mask, const uint8_t* valid,
                                  uint8_t* keep, int B, int S, int N,
                                  int n_obj, float thres, int max_keep,
                                  void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (n_obj < 1 || n_obj > 64 || N < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * (sizeof(unsigned long long) + 1);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        subgraph_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int warps = S < kNmsWarps * 32 ? (S + 31) / 32 : kNmsWarps;
  subgraph_nms_kernel<<<B, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      order, obj_ind, att_mask, valid, keep, S, N, n_obj, thres,
      max_keep < S ? max_keep : S);
  return (int)cudaGetLastError();
}
