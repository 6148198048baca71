// Beam-shared additive attention for the TopDown decoder, float32, Hopper.
//
// Replaces the TPU kernel subgc_tpu/ops/pallas_attention.py::
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
    float* eq = e_s + q * N;
    const float* mrow = mask + (size_t)s * N;
    float m = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, eq[j]);
    m = warp_max(m);
    float z = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float x = expf(eq[j] - m);
      eq[j] = x;
      z += x;
    }
    z = warp_sum(z);
    float z2 = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float x = eq[j] / z * mrow[j];
      eq[j] = x;
      z2 += x;
    }
    z2 = warp_sum(z2);
    float* wq = w_out + ((size_t)s0 * B + q) * N;
    for (int j = lane; j < N; j += 32) {
      const float x = eq[j] / z2;
      eq[j] = x;
      wq[j] = x;
    }
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
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      shared_attention_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + ROWS - 1) / ROWS);
  shared_attention_kernel<B><<<grid, kThreads, smem, stream>>>(
      h, p_att, att, mask, idx, wh, bh, v, bv, out, w, S, R, G, N, H, D);
  return cudaGetLastError();
}

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
