// Additive attention for the TopDown decoder, float32, Hopper: the
// beam-shared kernel (this note) and the per-row kernel (its own note
// further down), which share the warp reductions and the masked softmax.
//
// The beam-shared kernel replaces the TPU kernel subgc_tpu/ops/pallas_attention.py::
// _attention_shared_kernel (entry fused_attention_shared), generalised with a
// row -> stream index so that one kernel serves both beam layouts:
//
//   per-sub-graph streams: G = S, idx = arange(S)
//   image-shared streams:  G = images, idx = img_ix, mask = node membership
//
// For each row s and beam b (query q = s*B + b):
//   ah   = h[s,b] @ wh + bh                       [H]
//   e[j] = tanh(p_att[idx[s], j] + ah) @ v + bv   j < N
//   w    = softmax(e) * mask[s];  w /= sum(w)     (an all-zero mask gives NaN)
//   out  = w @ att[idx[s]]                        [D]
//
// What bounds it on an H100: for a 96-image batch in the image-shared layout
// (S=960 rows, B=2, R=D=1000, H=512, N=37) the work is ~2.2 GFLOP, almost
// all of it the h @ wh projection, against ~39 MB of compulsory traffic, so
// the bound is float32 CUDA-core operations (tensor cores are not used: the
// reference is full float32).  The per-sub-graph layout reads S copies of
// the streams instead and is bound by bytes.  The second pressure point is
// wh (R x H = 2 MB), which every block reads from L2.
//
// Design: one block of 1024 threads takes ROWS rows (ROWS*B ~ 4 queries).
// h is staged in shared memory k-major, so a thread reads its queries'
// values for one k as one float4 broadcast; each thread owns a column j of
// the projection and keeps 16 loads of wh in flight (the loop is bound by L2
// latency, not by the multiply-adds, at the main path's 20-160 row blocks).
// ah then lives in shared memory; one warp per (row, node) pair reduces
// tanh(.)*v over H for the row's B beams, reading each p_att element once;
// one warp per query runs the softmax over N nodes (lanes stride N, so
// N > 32 needs no cross-warp step); the weighted sum over att reads each
// stream element once per row for all B beams.  Consecutive rows of an image
// share one image's streams, which the image-shared layout reads from L2.
// Plain tanhf/expf, no fast math.
//
// The block shape was chosen with tools/sweep_attention_tiles.py: at the
// main path's 16-image batch (S=160) fewer queries per block win (more
// blocks in flight); at S=960, 8-16 queries per block read wh less often
// and are ~20% faster than this default (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

#include <algorithm>

namespace {

// Block shape and the unroll of the projection's k loop (loads of wh in
// flight per thread).  The defaults are the build's; tools/sweep_attention_tiles.py
// compiles other values with -D to time them.
#ifndef SUBGC_ATT_THREADS
#define SUBGC_ATT_THREADS 1024
#endif
#ifndef SUBGC_ATT_QUERIES
#define SUBGC_ATT_QUERIES 4
#endif
#ifndef SUBGC_ATT_UNROLL
#define SUBGC_ATT_UNROLL 16
#endif
constexpr int kThreads = SUBGC_ATT_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kQueries = SUBGC_ATT_QUERIES;  // target queries (row x beam)
constexpr int kUnroll = SUBGC_ATT_UNROLL;
constexpr size_t kMaxSmem = 227 * 1024;

template <int B>
struct Tile {
  static constexpr int ROWS = kQueries / B > 0 ? kQueries / B : 1;
  static constexpr int RB = ROWS * B;
};

// Admit smem bytes of dynamic shared memory for kernel: above 48 KB a
// kernel must opt in.
cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// One warp: softmax over the logits e[0, N) in place, times the mask row,
// renormalised, in the JAX chain's order (an all-zero mask gives 0/0 = NaN).
// Lanes stride over the nodes, so N > 32 needs no cross-warp step.  The
// weights stay in e and are written to w_out.
__device__ __forceinline__ void masked_softmax_warp(
    float* e, const float* __restrict__ mrow, float* __restrict__ w_out,
    int N, int lane) {
  float m = -CUDART_INF_F;
  for (int j = lane; j < N; j += 32) m = fmaxf(m, e[j]);
  m = warp_max(m);
  float z = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float x = expf(e[j] - m);
    e[j] = x;
    z += x;
  }
  z = warp_sum(z);
  float z2 = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float x = e[j] / z * mrow[j];
    e[j] = x;
    z2 += x;
  }
  z2 = warp_sum(z2);
  for (int j = lane; j < N; j += 32) {
    const float x = e[j] / z2;
    e[j] = x;
    w_out[j] = x;
  }
}

template <int B>
__global__ void __launch_bounds__(kThreads)
shared_attention_kernel(const float* __restrict__ h,
                        const float* __restrict__ p_att,
                        const float* __restrict__ att,
                        const float* __restrict__ mask,
                        const int* __restrict__ idx,
                        const float* __restrict__ wh,
                        const float* __restrict__ bh,
                        const float* __restrict__ v,
                        const float* __restrict__ bv,
                        float* __restrict__ out, float* __restrict__ w_out,
                        int S, int R, int G, int N, int H, int D) {
  constexpr int ROWS = Tile<B>::ROWS;
  constexpr int RB = Tile<B>::RB;
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);   // [R][RB], k-major
  float* ah_s = h_s + (size_t)R * RB;             // [RB][H]
  float* e_s = ah_s + (size_t)RB * H;             // [RB][N]: logits, weights
  __shared__ int g_s[ROWS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, S - s0);
  const int nq = rows * B;

  if (tid < ROWS) {
    // out-of-range stream indices clamp, as the JAX gather does
    const int g = tid < rows ? idx[s0 + tid] : 0;
    g_s[tid] = min(max(g, 0), G - 1);
  }
  const float* hb = h + (size_t)s0 * B * R;
  for (int i = tid; i < RB * R; i += kThreads) {
    const int q = i / R;
    const int k = i - q * R;
    h_s[k * RB + q] = q < nq ? hb[i] : 0.f;
  }
  __syncthreads();

  // ---- ah = h @ wh + bh: each thread owns columns j, all RB queries
  for (int j = tid; j < H; j += kThreads) {
    float acc[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) acc[q] = 0.f;
#pragma unroll kUnroll
    for (int k = 0; k < R; ++k) {
      const float wv = __ldg(wh + (size_t)k * H + j);
      if constexpr (RB % 4 == 0) {
        const float4* hk = reinterpret_cast<const float4*>(h_s + k * RB);
#pragma unroll
        for (int q4 = 0; q4 < RB / 4; ++q4) {
          const float4 x = hk[q4];
          acc[4 * q4 + 0] = fmaf(x.x, wv, acc[4 * q4 + 0]);
          acc[4 * q4 + 1] = fmaf(x.y, wv, acc[4 * q4 + 1]);
          acc[4 * q4 + 2] = fmaf(x.z, wv, acc[4 * q4 + 2]);
          acc[4 * q4 + 3] = fmaf(x.w, wv, acc[4 * q4 + 3]);
        }
      } else {
        const float* hk = h_s + k * RB;
#pragma unroll
        for (int q = 0; q < RB; ++q) acc[q] = fmaf(hk[q], wv, acc[q]);
      }
    }
    const float b = bh[j];
#pragma unroll
    for (int q = 0; q < RB; ++q) ah_s[q * H + j] = acc[q] + b;
  }
  __syncthreads();

  // ---- e[q, j] = tanh(p_att[g, j] + ah[q]) @ v + bv: a warp per (row, j),
  // each p_att element read once for the row's B beams
  const float bias_v = bv[0];
  for (int p = warp; p < rows * N; p += kWarps) {
    const int r = p / N;
    const int j = p - r * N;
    const float* pr = p_att + ((size_t)g_s[r] * N + j) * H;
    const float* ar = ah_s + (size_t)r * B * H;
    float sum[B];
#pragma unroll
    for (int b = 0; b < B; ++b) sum[b] = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float pc = __ldg(pr + c);
      const float vc = __ldg(v + c);
#pragma unroll
      for (int b = 0; b < B; ++b)
        sum[b] = fmaf(tanhf(pc + ar[b * H + c]), vc, sum[b]);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float e = warp_sum(sum[b]);
      if (lane == 0) e_s[(r * B + b) * N + j] = e + bias_v;
    }
  }
  __syncthreads();

  // ---- softmax over nodes, mask, renormalise: a warp per query
  for (int q = warp; q < nq; q += kWarps) {
    const int s = s0 + q / B;
    masked_softmax_warp(e_s + q * N, mask + (size_t)s * N,
                        w_out + ((size_t)s0 * B + q) * N, N, lane);
  }
  __syncthreads();

  // ---- out[s, b] = w[s, b] @ att[g]: each stream element read once per row
  for (int r = 0; r < rows; ++r) {
    const float* ag = att + (size_t)g_s[r] * N * D;
    const float* wr = e_s + r * B * N;
    float* orow = out + (size_t)(s0 + r) * B * D;
    for (int d = tid; d < D; d += kThreads) {
      float acc[B];
#pragma unroll
      for (int b = 0; b < B; ++b) acc[b] = 0.f;
      for (int j = 0; j < N; ++j) {
        const float a = __ldg(ag + (size_t)j * D + d);
#pragma unroll
        for (int b = 0; b < B; ++b) acc[b] = fmaf(wr[b * N + j], a, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < B; ++b) orow[b * D + d] = acc[b];
    }
  }
}

template <int B>
cudaError_t launch(const float* h, const float* p_att, const float* att,
                   const float* mask, const int* idx, const float* wh,
                   const float* bh, const float* v, const float* bv,
                   float* out, float* w, int S, int R, int G, int N, int H,
                   int D, cudaStream_t stream) {
  constexpr int ROWS = Tile<B>::ROWS;
  constexpr int RB = Tile<B>::RB;
  const size_t smem =
      sizeof(float) * ((size_t)R * RB + (size_t)RB * H + (size_t)RB * N);
  const cudaError_t err =
      set_smem((const void*)shared_attention_kernel<B>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + ROWS - 1) / ROWS);
  shared_attention_kernel<B><<<grid, kThreads, smem, stream>>>(
      h, p_att, att, mask, idx, wh, bh, v, bv, out, w, S, R, G, N, H, D);
  return cudaGetLastError();
}

// ===========================================================================
// Per-row additive attention.
//
// Replaces the TPU kernel subgc_tpu/ops/pallas_attention.py::
// _attention_kernel (entry fused_attention): the same chain with one query
// per row and each row's own [N, H] / [N, D] streams (the attention-capture
// layout of the grounding decode):
//
//   ah   = h[r] @ wh + bh                        [H]
//   e[j] = tanh(p_att[r, j] + ah) @ v + bv       j < N
//   w    = softmax(e) * mask[r];  w /= sum(w)    (an all-zero mask gives NaN)
//   out  = w @ att[r]                            [D]
//
// What bounds it on an H100: bytes.  Rows share no streams, so each row
// reads its own N x (H + D) floats (37 x 1512 x 4 B ~ 224 KB at full width);
// at the grounding path's 16-image batch (R = 160, Hin = D = 1000, H = 512)
// that is ~39 MB against ~0.18 GFLOP, 0.0117 ms of HBM time against
// 0.0027 ms of float32 operations.
//
// Design: two launches, both from subgc_row_attention_f32.
// 1. row_project_kernel forms h @ wh in tiles of kProjRows rows x kProjCols
//    columns, so wh (Hin x H, 2 MB) is read from L2 once per tile of rows
//    rather than once per row; the k axis is split over gridDim.z so that
//    a 160-row batch still starts ~2 blocks per SM.  Each split writes its
//    partial sums to a [splits, R, H] scratch (no atomics: the result does
//    not depend on the order blocks run in).
// 2. row_attention_kernel gives each row a block of kRowThreads threads, so
//    the byte-bound stream reads spread over every SM: it sums the partials
//    and bh into ah in shared memory, one warp per node reduces
//    tanh(p + ah) * v over H (float4 loads, 4 in flight per lane), warp 0
//    runs the masked softmax, and each thread owns 4 columns of the
//    weighted sum over att (8 loads in flight).
// Plain tanhf/expf, no fast math.
// ===========================================================================

constexpr int kProjRows = 16;     // rows of a projection tile (accumulators)
constexpr int kProjCols = 128;    // columns of a projection tile (threads)
constexpr int kProjUnroll = 16;   // loads of wh in flight per thread
constexpr int kProjMinChunk = 64; // least k per split
constexpr int kProjMaxSplits = 8;
constexpr int kTargetBlocks = 2 * 132;   // two blocks per SM of an H100 SXM
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

__global__ void __launch_bounds__(kProjCols)
row_project_kernel(const float* __restrict__ h, const float* __restrict__ wh,
                   float* __restrict__ part, int R, int Hin, int H,
                   int kchunk) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);   // [kchunk][kProjRows]
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kProjCols + tid;
  const int r0 = blockIdx.y * kProjRows;
  const int rows = min(kProjRows, R - r0);
  const int k0 = blockIdx.z * kchunk;
  const int kn = min(kchunk, Hin - k0);
  for (int i = tid; i < kProjRows * kn; i += kProjCols) {
    const int q = i / kn;
    const int k = i - q * kn;
    h_s[k * kProjRows + q] =
        q < rows ? h[(size_t)(r0 + q) * Hin + k0 + k] : 0.f;
  }
  __syncthreads();
  if (j >= H) return;

  float acc[kProjRows];
#pragma unroll
  for (int q = 0; q < kProjRows; ++q) acc[q] = 0.f;
  const float* wcol = wh + (size_t)k0 * H + j;
#pragma unroll kProjUnroll
  for (int k = 0; k < kn; ++k) {
    const float wv = __ldg(wcol + (size_t)k * H);
    const float4* hk = reinterpret_cast<const float4*>(h_s + k * kProjRows);
#pragma unroll
    for (int q4 = 0; q4 < kProjRows / 4; ++q4) {
      const float4 x = hk[q4];
      acc[4 * q4 + 0] = fmaf(x.x, wv, acc[4 * q4 + 0]);
      acc[4 * q4 + 1] = fmaf(x.y, wv, acc[4 * q4 + 1]);
      acc[4 * q4 + 2] = fmaf(x.z, wv, acc[4 * q4 + 2]);
      acc[4 * q4 + 3] = fmaf(x.w, wv, acc[4 * q4 + 3]);
    }
  }
  float* prow = part + ((size_t)blockIdx.z * R + r0) * H + j;
  for (int q = 0; q < rows; ++q) prow[(size_t)q * H] = acc[q];
}

// VEC: H and D are multiples of 4 and the streams are 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(kRowThreads)
row_attention_kernel(const float* __restrict__ p_att,
                     const float* __restrict__ att,
                     const float* __restrict__ mask,
                     const float* __restrict__ part,
                     const float* __restrict__ bh,
                     const float* __restrict__ v,
                     const float* __restrict__ bv,
                     float* __restrict__ out, float* __restrict__ w_out,
                     int R, int N, int H, int D, int splits) {
  extern __shared__ float4 smem4[];
  float* ah_s = reinterpret_cast<float*>(smem4);  // [H]
  float* v_s = ah_s + H;                           // [H]
  float* e_s = v_s + H;                            // [N]: logits, weights
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = blockIdx.x;

  // ---- ah = (sum of the k-split partials) + bh
  for (int c = tid; c < H; c += kRowThreads) {
    float a = part[(size_t)r * H + c];
    for (int z = 1; z < splits; ++z) a += part[((size_t)z * R + r) * H + c];
    ah_s[c] = a + bh[c];
    v_s[c] = v[c];
  }
  __syncthreads();

  // ---- e[j] = tanh(p_att[r, j] + ah) @ v + bv: a warp per node
  const float bias_v = bv[0];
  for (int j = warp; j < N; j += kRowWarps) {
    const float* pr = p_att + ((size_t)r * N + j) * H;
    float sum = 0.f;
    if constexpr (VEC) {
      const float4* p4 = reinterpret_cast<const float4*>(pr);
      const float4* a4 = reinterpret_cast<const float4*>(ah_s);
      const float4* v4 = reinterpret_cast<const float4*>(v_s);
#pragma unroll 4
      for (int c = lane; c < H / 4; c += 32) {
        const float4 p = __ldg(p4 + c);
        const float4 a = a4[c];
        const float4 vc = v4[c];
        sum = fmaf(tanhf(p.x + a.x), vc.x, sum);
        sum = fmaf(tanhf(p.y + a.y), vc.y, sum);
        sum = fmaf(tanhf(p.z + a.z), vc.z, sum);
        sum = fmaf(tanhf(p.w + a.w), vc.w, sum);
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < H; c += 32)
        sum = fmaf(tanhf(__ldg(pr + c) + ah_s[c]), v_s[c], sum);
    }
    sum = warp_sum(sum);
    if (lane == 0) e_s[j] = sum + bias_v;
  }
  __syncthreads();

  if (warp == 0)
    masked_softmax_warp(e_s, mask + (size_t)r * N, w_out + (size_t)r * N, N,
                        lane);
  __syncthreads();

  // ---- out[r] = w @ att[r]: each thread owns 4 columns (VEC) or 1
  const float* ar = att + (size_t)r * N * D;
  float* orow = out + (size_t)r * D;
  if constexpr (VEC) {
    const int D4 = D / 4;
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    for (int d = tid; d < D4; d += kRowThreads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int j = 0; j < N; ++j) {
        const float4 a = __ldg(a4 + (size_t)j * D4 + d);
        const float wj = e_s[j];
        acc.x = fmaf(wj, a.x, acc.x);
        acc.y = fmaf(wj, a.y, acc.y);
        acc.z = fmaf(wj, a.z, acc.z);
        acc.w = fmaf(wj, a.w, acc.w);
      }
      reinterpret_cast<float4*>(orow)[d] = acc;
    }
  } else {
    for (int d = tid; d < D; d += kRowThreads) {
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < N; ++j)
        acc = fmaf(e_s[j], __ldg(ar + (size_t)j * D + d), acc);
      orow[d] = acc;
    }
  }
}

// k per split for a split count (subgc_row_attention_splits then trims the
// count so that no split is empty).
int row_chunk(int Hin, int splits) { return (Hin + splits - 1) / splits; }

}  // namespace

// Returns a cudaError_t (0 on success).  All pointers are device pointers to
// contiguous float32 (idx: int32) arrays; stream is a cudaStream_t.
extern "C" int subgc_shared_attention_f32(
    const float* h, const float* p_att, const float* att, const float* mask,
    const int* idx, const float* wh, const float* bh, const float* v,
    const float* bv, float* out, float* w, int S, int B, int R, int G, int N,
    int H, int D, void* stream) {
  if (S <= 0) return 0;
  if (G <= 0 || N <= 0 || R <= 0 || H <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 1: return (int)launch<1>(h, p_att, att, mask, idx, wh, bh, v, bv, out, w, S, R, G, N, H, D, st);
    case 2: return (int)launch<2>(h, p_att, att, mask, idx, wh, bh, v, bv, out, w, S, R, G, N, H, D, st);
    case 3: return (int)launch<3>(h, p_att, att, mask, idx, wh, bh, v, bv, out, w, S, R, G, N, H, D, st);
    case 4: return (int)launch<4>(h, p_att, att, mask, idx, wh, bh, v, bv, out, w, S, R, G, N, H, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The number of k splits subgc_row_attention_f32 takes for R rows: enough
// projection blocks for ~2 per SM, at least kProjMinChunk k per split, and
// no empty split.  The caller sizes the [splits, R, H] scratch with it.
extern "C" int subgc_row_attention_splits(int R, int Hin, int H) {
  if (R <= 0 || Hin <= 0 || H <= 0) return 1;
  const int tiles = ((H + kProjCols - 1) / kProjCols) *
                    ((R + kProjRows - 1) / kProjRows);
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = std::min(splits, std::min(kProjMaxSplits, Hin / kProjMinChunk));
  splits = std::max(splits, 1);
  return (Hin + row_chunk(Hin, splits) - 1) / row_chunk(Hin, splits);
}

// Returns a cudaError_t (0 on success).  All pointers are device pointers to
// contiguous float32 arrays: h [R, Hin], p_att [R, N, H], att [R, N, D],
// mask [R, N], wh [Hin, H], bh [H], v [H, 1], bv [1]; part is scratch of
// [splits, R, H] with splits = subgc_row_attention_splits(R, Hin, H); out
// [R, D] and w [R, N] are written.  stream is a cudaStream_t.
extern "C" int subgc_row_attention_f32(
    const float* h, const float* p_att, const float* att, const float* mask,
    const float* wh, const float* bh, const float* v, const float* bv,
    float* part, float* out, float* w, int R, int Hin, int N, int H, int D,
    int splits, void* stream) {
  if (R <= 0) return 0;
  if (Hin <= 0 || N <= 0 || H <= 0 || D <= 0 || splits < 1 || splits > Hin)
    return (int)cudaErrorInvalidValue;
  const int kchunk = row_chunk(Hin, splits);
  if ((splits - 1) * kchunk >= Hin) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const size_t proj_smem = sizeof(float) * (size_t)kchunk * kProjRows;
  cudaError_t err = set_smem((const void*)row_project_kernel, proj_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 pgrid((H + kProjCols - 1) / kProjCols,
                   (R + kProjRows - 1) / kProjRows, splits);
  row_project_kernel<<<pgrid, kProjCols, proj_smem, st>>>(h, wh, part, R, Hin,
                                                          H, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t row_smem = sizeof(float) * (2 * (size_t)H + N);
  const bool vec = H % 4 == 0 && D % 4 == 0 &&
                   ((reinterpret_cast<size_t>(p_att) |
                     reinterpret_cast<size_t>(att) |
                     reinterpret_cast<size_t>(out)) & 15) == 0;
  if (vec) {
    err = set_smem((const void*)row_attention_kernel<true>, row_smem);
    if (err != cudaSuccess) return (int)err;
    row_attention_kernel<true><<<R, kRowThreads, row_smem, st>>>(
        p_att, att, mask, part, bh, v, bv, out, w, R, N, H, D, splits);
  } else {
    err = set_smem((const void*)row_attention_kernel<false>, row_smem);
    if (err != cudaSuccess) return (int)err;
    row_attention_kernel<false><<<R, kRowThreads, row_smem, st>>>(
        p_att, att, mask, part, bh, v, bv, out, w, R, N, H, D, splits);
  }
  return (int)cudaGetLastError();
}
