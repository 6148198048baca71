// Additive attention for the TopDown decoder, Hopper, in two stages that
// both wrappers share: a staged projection (project_kernel) and an
// attention kernel (attend_kernel), each in float32 and in a bfloat16
// storage variant.
//
// They replace the two TPU kernels of subgc_tpu/ops/pallas_attention.py:
//
//   _attention_shared_kernel (entry fused_attention_shared): each row's
//     streams serve its B beams.  Generalised with a row -> stream index so
//     that one kernel serves both beam layouts and the greedy fan-out:
//       per-sub-graph streams: G = S, idx = arange(S)
//       image-shared streams:  G = images, idx = img_ix, mask = membership
//   _attention_kernel (entry fused_attention): one query per row over the
//     row's own streams; here the same kernels at B = 1, idx = arange(R).
//
// For each row s and beam b (query q = s*B + b):
//   ah   = h[s,b] @ wh + bh                       [H]
//   e[j] = tanh(p_att[idx[s], j] + ah) @ v + bv   j < N
//   w    = softmax(e) * mask[s];  w /= sum(w)     (an all-zero mask gives NaN)
//   out  = w @ att[idx[s]]                        [D]
//
// Storage dtypes.  The Pallas kernels are generic over the streams' dtype;
// so are these.  In the *_bf16 entries h, p_att, att, wh and v are
// bfloat16 and bh, bv and mask float32; every output is float32.  Where
// each op rounds to bfloat16 (round to nearest even, __float2bfloat16_rn):
//
//   stage            shared (_attention_shared_kernel)  row (_attention_kernel)
//   ah = h wh + bh   f32 sums of the exact products,    f32, not rounded
//                    + bh, then ONE rounding
//   p + ah, tanh     add rounded, tanh rounded          f32 (p upcast)
//   e = dot v + bv   f32, not rounded                   f32
//   softmax, renorm  f32                                f32
//   weighted sum     w rounded, f32 sums                w f32, att upcast
//   outputs          att_res f32 (its consumer rounds   both f32
//                    it, as Pallas does), w f32
//
// Bf16 values convert to float exactly, so every product of two of them is
// exact in float32 and only the order of the float32 sums differs from the
// plain versions (ops/attention.py).
//
// What bounds it on an H100 (full width: Hin = D = 1000, H = 512, N = 37):
// the projection h @ wh is nearly all of the operations (2 Hin H FLOP per
// query), so the image-shared layouts, whose rows share few streams, are
// bound by float32 CUDA-core operations (no tensor cores: the float32
// reference is full float32 and TF32 would break its tolerance).  Rows with
// streams of their own (per-sub-graph, per-row) read N (H + D) floats each,
// 224 KB, and are bound by bytes.  Above the multiply-add bound sit the
// S B N H accurate tanhf evaluations.  In bfloat16 the streams take half
// the bytes (a p_att row is 1,024 B, an att row 2,000 B) and the card's
// bound for the same work is set by bytes; these kernels still multiply in
// float32 on the CUDA cores (the bf16 products are exact there), so their
// operation count, not the bound, sets their time at image-shared shapes.
//
// Design.
// 1. project_kernel: a SIMT SGEMM.  A block owns a BM x BN tile of the
//    queries' projections; the k-slices of h and wh pass through a ring of
//    kStages shared-memory stages, so the next slices load while the block
//    multiplies the current one.  Float32 slices are filled by cp.async
//    (16-byte copies where rows are 16-byte aligned, else 4-byte); bfloat16
//    slices go through registers (one 8-byte load of 4 values where rows
//    are 8-byte aligned, else one value at a time) and are stored as float,
//    so the ring and the multiply are the float32 ones.  Each thread keeps
//    an 8 x 4 register tile: per four k it reads 8 + 4 float4s from shared
//    memory for 128 multiply-adds.  wh is read from L2 once per BM queries,
//    not once per block of 4 queries.  Where the tiles alone would not
//    give ~2 blocks per SM, k is split over gridDim.z and each split writes
//    its partial sums to a [splits, Q, H] scratch; the consumer adds them in
//    split order (no atomics: the result does not depend on block order).
//    The plan (BM, BN, splits) comes from the caller (ops/attention.py).
// 2. attend_kernel: a block owns rows_per_block consecutive rows.  It sums
//    the partials and bh into ah in shared memory (rounded once in the
//    shared bf16 rule), then walks the runs of its rows that share a
//    stream: one thread starts bulk copies (cp.async.bulk, an mbarrier per
//    8 nodes) of the stream's p_att, in its storage dtype, into shared
//    memory, and a warp starts on a node as soon as its chunk has landed.
//    A warp per node reduces tanh(p + ah) * v over H for every query of the
//    run, reading each p_att element once for all of them; a warp per query
//    runs the masked softmax in the JAX order; each thread owns 4 columns
//    of the weighted sum over att, keeps 8 loads of att (float4, or 4
//    bf16) in flight and reads each att element once for all queries of the
//    run.  Rows with streams of their own are one row per block; in the
//    image-shared layouts a block takes up to 16 queries.
// Plain tanhf/expf, no fast math.
//
// Measured on an H100 (PERF.md): the attention stage is bound by the
// latency of its serial phases more than by tanhf; an L2 prefetch of att
// during the tanh phase, and starting the first stream copy before the
// partial sums, were both slower and are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr size_t kMaxSmem = 227 * 1024;

// Admit smem bytes of dynamic shared memory for kernel: above 48 KB a
// kernel must opt in.
cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// ---- storage-dtype helpers (bf16 -> float is exact)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// x rounded to bfloat16 (nearest even), as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_bits(uint32_t bits16) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)bits16));
}

// 4 consecutive values as floats: float32 one 16-byte load (16-byte
// aligned), bfloat16 one 8-byte load (8-byte aligned).  ldg4 reads through
// the read-only path (global memory only), lds4 plainly (shared memory).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_bits(u.x & 0xffffu), bf16_bits(u.x >> 16),
                     bf16_bits(u.y & 0xffffu), bf16_bits(u.y >> 16));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_bits(u.x & 0xffffu), bf16_bits(u.x >> 16),
                     bf16_bits(u.y & 0xffffu), bf16_bits(u.y >> 16));
}
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) { return to_float(*p); }

// 4 bf16 values from global memory as floats; those at or past `valid`
// read as 0 (and are not touched).  vec: one aligned 8-byte load when all
// 4 are valid.
__device__ __forceinline__ float4 load4_bounded(const bf16* p, int valid,
                                                int vec) {
  if (vec && valid == 4) return ldg4(p);
  float x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) x[u] = u < valid ? to_float(p[u]) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// tanh of a logit term: in the shared bf16 rule the add and the tanh each
// round to bfloat16 (p and ah are bf16 values already); else float32.
template <bool ROUND>
__device__ __forceinline__ float act(float x) {
  return ROUND ? round_bf16(tanhf(round_bf16(x))) : tanhf(x);
}

// One warp: softmax over the logits e[0, N) in place, times the mask row,
// renormalised, in the JAX chain's order (an all-zero mask gives 0/0 = NaN).
// Lanes stride over the nodes, so N > 32 needs no cross-warp step.  The
// weights are written to w_out and stay in e, rounded to bfloat16 there in
// the shared bf16 rule (the weighted sum reads them).
template <bool ROUND>
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
    e[j] = ROUND ? round_bf16(x) : x;
    w_out[j] = x;
  }
}

// ---- cp.async (global -> shared; the bytes past `valid` are zero-filled)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- mbarriers and bulk copies
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes: a multiple of 16; dst and src 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ===========================================================================
// Stage 1: part[z, q, :] = h[q, kz] @ wh[kz, :] over split z's k range kz.
// ===========================================================================

constexpr int kBK = 16;              // k per ring slice
constexpr int kTM = 8;               // rows of a thread's register tile
constexpr int kTN = 4;               // columns of a thread's register tile
constexpr int kStages = 3;           // slices in the ring
constexpr int kAStride = kBK + 4;    // padded row of an h slice (floats)

// TIn: float or bf16 (h and wh); the ring, the multiply and part are
// float32 either way.
template <typename TIn, int BM, int BN>
__global__ void __launch_bounds__(BM * BN / (kTM * kTN))
project_kernel(const TIn* __restrict__ h, const TIn* __restrict__ wh,
               float* __restrict__ part, int Q, int Hin, int H, int kchunk,
               int vec) {
  constexpr int T = BM * BN / (kTM * kTN);
  constexpr int CG = BN / kTN;   // column groups
  constexpr int RS = BM / kTM;   // stride between a thread's rows
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [kStages][BM][kAStride]
  float* Bs = As + kStages * BM * kAStride;      // [kStages][kBK][BN]

  const int tid = threadIdx.x;
  const int tr = tid / CG;
  const int tc = tid - tr * CG;
  const int q0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(kb + kchunk, Hin);
  const int nk = (ke - kb + kBK - 1) / kBK;

  auto load = [&](int t, int st) {
    const int k0 = kb + t * kBK;
    float* as = As + st * BM * kAStride;
    float* bs = Bs + st * kBK * BN;
    if constexpr (std::is_same<TIn, float>::value) {
      if (vec) {
#pragma unroll
        for (int i = tid; i < BM * kBK / 4; i += T) {
          const int r = i / (kBK / 4);
          const int c = (i - r * (kBK / 4)) * 4;
          const int q = q0 + r, k = k0 + c;
          const int valid = q < Q ? min(max((ke - k) * 4, 0), 16) : 0;
          cp_async16(as + r * kAStride + c,
                     valid ? h + (size_t)q * Hin + k : h, valid);
        }
#pragma unroll
        for (int i = tid; i < kBK * BN / 4; i += T) {
          const int r = i / (BN / 4);
          const int c = (i - r * (BN / 4)) * 4;
          const int k = k0 + r, j = j0 + c;
          const int valid = k < ke ? min(max((H - j) * 4, 0), 16) : 0;
          cp_async16(bs + r * BN + c, valid ? wh + (size_t)k * H + j : wh,
                     valid);
        }
      } else {
#pragma unroll 4
        for (int i = tid; i < BM * kBK; i += T) {
          const int r = i / kBK;
          const int c = i - r * kBK;
          const int q = q0 + r, k = k0 + c;
          const int valid = q < Q && k < ke ? 4 : 0;
          cp_async4(as + r * kAStride + c,
                    valid ? h + (size_t)q * Hin + k : h, valid);
        }
#pragma unroll 4
        for (int i = tid; i < kBK * BN; i += T) {
          const int r = i / BN;
          const int c = i - r * BN;
          const int k = k0 + r, j = j0 + c;
          const int valid = k < ke && j < H ? 4 : 0;
          cp_async4(bs + r * BN + c, valid ? wh + (size_t)k * H + j : wh,
                    valid);
        }
      }
    } else {
      // bfloat16: 4 values a thread through registers, stored as float
      // (exact); the stage of t - 1 is free (the __syncthreads before this
      // load), and the next __syncthreads publishes these stores
#pragma unroll
      for (int i = tid; i < BM * kBK / 4; i += T) {
        const int r = i / (kBK / 4);
        const int c = (i - r * (kBK / 4)) * 4;
        const int q = q0 + r, k = k0 + c;
        const int valid = q < Q ? min(max(ke - k, 0), 4) : 0;
        *reinterpret_cast<float4*>(as + r * kAStride + c) =
            load4_bounded(h + (size_t)q * Hin + k, valid, vec);
      }
#pragma unroll
      for (int i = tid; i < kBK * BN / 4; i += T) {
        const int r = i / (BN / 4);
        const int c = (i - r * (BN / 4)) * 4;
        const int k = k0 + r, j = j0 + c;
        const int valid = k < ke ? min(max(H - j, 0), 4) : 0;
        *reinterpret_cast<float4*>(bs + r * BN + c) =
            load4_bounded(wh + (size_t)k * H + j, valid, vec);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();   // slice t has landed
    __syncthreads();                // and every thread is done with t - 1
    const int tn = t + kStages - 1;
    if (tn < nk) load(tn, tn % kStages);   // into the stage of t - 1
    cp_async_commit();
    const float* as = As + (t % kStages) * BM * kAStride;
    const float* bs = Bs + (t % kStages) * kBK * BN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[kTM];
      float4 b[4];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (tr + i * RS) * kAStride
                                                + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(bs + (kk + c) * BN
                                                + tc * kTN);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][0] = fmaf(av[c], b[c].x, acc[i][0]);
          acc[i][1] = fmaf(av[c], b[c].y, acc[i][1]);
          acc[i][2] = fmaf(av[c], b[c].z, acc[i][2]);
          acc[i][3] = fmaf(av[c], b[c].w, acc[i][3]);
        }
      }
    }
  }

  float* out = part + (size_t)blockIdx.z * Q * H;
  const int j = j0 + tc * kTN;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int q = q0 + tr + i * RS;
    if (q >= Q) continue;
    float* orow = out + (size_t)q * H;
    if (vec && j + kTN <= H) {
      *reinterpret_cast<float4*>(orow + j) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kTN; ++c)
        if (j + c < H) orow[j + c] = acc[i][c];
    }
  }
}

// ah = (sum of the split partials, in split order) + bh: the standalone
// projection's epilogue; attend_kernel forms the same sum itself.
__global__ void project_sum_kernel(const float* __restrict__ part,
                                   const float* __restrict__ bh,
                                   float* __restrict__ ah, int Q, int H,
                                   int splits) {
  const size_t n = (size_t)Q * H;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = part[i];
  for (int z = 1; z < splits; ++z) a += part[z * n + i];
  ah[i] = a + bh[i % H];
}

// k per split: whole ring slices.  The plan is valid when no split is empty.
int project_chunk(int Hin, int splits) {
  const int slices = (Hin + kBK - 1) / kBK;
  return (slices + splits - 1) / splits * kBK;
}

template <typename TIn, int BM, int BN>
cudaError_t launch_project_tile(const TIn* h, const TIn* wh, float* part,
                                int Q, int Hin, int H, int splits, int vec,
                                cudaStream_t st) {
  const size_t smem =
      sizeof(float) * kStages * ((size_t)BM * kAStride + (size_t)kBK * BN);
  const cudaError_t err =
      set_smem((const void*)project_kernel<TIn, BM, BN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + BM - 1) / BM, (H + BN - 1) / BN, splits);
  project_kernel<TIn, BM, BN><<<grid, BM * BN / (kTM * kTN), smem, st>>>(
      h, wh, part, Q, Hin, H, project_chunk(Hin, splits), vec);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<size_t>(p) & (bytes - 1)) == 0;
}

bool aligned16(const void* p) { return aligned(p, 16); }

// vec: rows of 4 values load whole (float32: 16-byte cp.async; bfloat16:
// 8-byte loads) and part stores float4s.
template <typename TIn>
cudaError_t launch_project(const TIn* h, const TIn* wh, float* part, int Q,
                           int Hin, int H, int bm, int bn, int splits,
                           cudaStream_t st) {
  if (Hin <= 0 || H <= 0 || splits < 1 ||
      (splits - 1) * project_chunk(Hin, splits) >= Hin)
    return cudaErrorInvalidValue;   // an empty split
  const int vec = Hin % 4 == 0 && H % 4 == 0 &&
                  aligned(h, 4 * sizeof(TIn)) &&
                  aligned(wh, 4 * sizeof(TIn)) && aligned16(part);
#define SUBGC_TILE(M, N)                                                     \
  if (bm == M && bn == N)                                                    \
    return launch_project_tile<TIn, M, N>(h, wh, part, Q, Hin, H, splits,    \
                                          vec, st);
  SUBGC_TILE(32, 64)
  SUBGC_TILE(64, 64)
  SUBGC_TILE(128, 64)
  SUBGC_TILE(32, 128)
  SUBGC_TILE(64, 128)
  SUBGC_TILE(128, 128)
#undef SUBGC_TILE
  return cudaErrorInvalidValue;
}

// ===========================================================================
// Stage 2: attention over each row's stream for its queries.
// ===========================================================================

constexpr int kAttThreads = 256;
constexpr int kAttWarps = kAttThreads / 32;
constexpr int kNodeChunk = 8;     // nodes per bulk copy (one mbarrier each)
constexpr int kMaxQueries = 16;   // queries per block, largest QMAX
constexpr int kAttLoads = 8;      // loads of att in flight per thread

__host__ __device__ __forceinline__ size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of attend_kernel, in bytes: mbarriers (one per node
// chunk), p_att [N][H] in its storage dtype, then float ah [QMAX][H],
// v [H], logits [QMAX][N]; each region starts 16-byte aligned.
size_t attend_smem(int qmax, int N, int H, size_t elem) {
  const size_t nch = (N + kNodeChunk - 1) / kNodeChunk;
  return round16(nch * 8) + round16((size_t)N * H * elem) +
         sizeof(float) * ((size_t)qmax * H + H + (size_t)qmax * N);
}

// T: the streams' storage dtype (float or bf16).  ROUND: the shared bf16
// rounding rule (see the top of this file); false for float32 and for the
// row kernel's bf16 streams.  VEC: p_att goes by bulk copy and att by 4
// values a load (H a multiple of 16 bytes' worth, D of 4, the streams and
// out aligned).  idx == nullptr: row s reads stream s.
template <typename T, bool ROUND, int QMAX, bool VEC>
__global__ void __launch_bounds__(kAttThreads)
attend_kernel(const T* __restrict__ p_att, const T* __restrict__ att,
              const float* __restrict__ mask, const int* __restrict__ idx,
              const float* __restrict__ part, const float* __restrict__ bh,
              const T* __restrict__ v, const float* __restrict__ bv,
              float* __restrict__ out, float* __restrict__ w_out, int S,
              int B, int G, int N, int H, int D, int splits, int rpb) {
  extern __shared__ float4 smem4[];
  const int nch = (N + kNodeChunk - 1) / kNodeChunk;
  char* base = reinterpret_cast<char*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  T* p_s = reinterpret_cast<T*>(base + round16((size_t)nch * 8));
  float* ah_s = reinterpret_cast<float*>(
      reinterpret_cast<char*>(p_s) + round16((size_t)N * H * sizeof(T)));
  float* v_s = ah_s + (size_t)QMAX * H; // [H]
  float* e_s = v_s + H;                 // [QMAX][N]: logits, then weights
  __shared__ int g_s[QMAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = blockIdx.x * rpb;
  const int rows = min(rpb, S - s0);
  const int nq = rows * B;
  const size_t Q = (size_t)S * B;
  const size_t q0 = (size_t)s0 * B;

  if (tid < rows) {
    // out-of-range stream indices clamp, as the JAX gather does
    const int g = idx ? idx[s0 + tid] : s0 + tid;
    g_s[tid] = min(max(g, 0), G - 1);
  }
  if (VEC && tid == 0) {
    for (int c = 0; c < nch; ++c) mbar_init(bar + c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // ---- ah = (sum of the split partials) + bh, for the block's queries
  for (int i = tid; i < nq * H; i += kAttThreads) {
    const int q = i / H;
    const int c = i - q * H;
    const float* pq = part + (q0 + q) * H + c;
    float a = pq[0];
    for (int z = 1; z < splits; ++z) a += pq[z * Q * H];
    a += bh[c];
    ah_s[i] = ROUND ? round_bf16(a) : a;
  }
  for (int c = tid; c < H; c += kAttThreads) v_s[c] = to_float(v[c]);
  __syncthreads();

  const float bias_v = bv[0];
  uint32_t parity = 0;
  // ---- the runs of rows [r0, r1) that share one stream
  for (int r0 = 0; r0 < rows;) {
    const int g = g_s[r0];
    int r1 = r0 + 1;
    while (r1 < rows && g_s[r1] == g) ++r1;
    const int qa = r0 * B, qb = r1 * B;
    const T* pg = p_att + (size_t)g * N * H;
    const T* ag = att + (size_t)g * N * D;

    // stage p_att[g] in shared memory (VEC: bulk copies, thread 0 issues)
    if (VEC) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int c = 0; c < nch; ++c) {
          const int n0 = c * kNodeChunk;
          const int bytes = min(kNodeChunk, N - n0) * H * (int)sizeof(T);
          mbar_expect_tx(bar + c, bytes);
          bulk_copy(p_s + (size_t)n0 * H, pg + (size_t)n0 * H, bytes,
                    bar + c);
        }
      }
    } else {
      for (int i = tid; i < N * H; i += kAttThreads) p_s[i] = pg[i];
      __syncthreads();
    }

    // ---- e[q, j] = tanh(p[j] + ah[q]) @ v + bv: a warp per node j, every
    // query of the run, each p element read once
    for (int j = warp; j < N; j += kAttWarps) {
      if (VEC) mbar_wait(bar + j / kNodeChunk, parity);
      const T* pr = p_s + (size_t)j * H;
      float sum[QMAX];
#pragma unroll
      for (int q = 0; q < QMAX; ++q) sum[q] = 0.f;
      if (VEC) {
        for (int c = lane * 4; c < H; c += 128) {
          const float4 p = lds4(pr + c);
          const float4 vc = *reinterpret_cast<const float4*>(v_s + c);
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (qa + q >= qb) break;
            const float4 a =
                *reinterpret_cast<const float4*>(ah_s + (qa + q) * H + c);
            float s = sum[q];
            s = fmaf(act<ROUND>(p.x + a.x), vc.x, s);
            s = fmaf(act<ROUND>(p.y + a.y), vc.y, s);
            s = fmaf(act<ROUND>(p.z + a.z), vc.z, s);
            s = fmaf(act<ROUND>(p.w + a.w), vc.w, s);
            sum[q] = s;
          }
        }
      } else {
        for (int c = lane; c < H; c += 32) {
          const float p = to_float(pr[c]);
          const float vc = v_s[c];
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (qa + q >= qb) break;
            sum[q] = fmaf(act<ROUND>(p + ah_s[(qa + q) * H + c]), vc,
                          sum[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (qa + q >= qb) break;
        const float e = warp_sum(sum[q]);
        if (lane == 0) e_s[(qa + q) * N + j] = e + bias_v;
      }
    }
    __syncthreads();

    // ---- softmax over nodes, mask, renormalise: a warp per query
    for (int q = qa + warp; q < qb; q += kAttWarps)
      masked_softmax_warp<ROUND>(e_s + q * N,
                                 mask + (size_t)(s0 + q / B) * N,
                                 w_out + (q0 + q) * N, N, lane);
    __syncthreads();

    // ---- out[q] = w[q] @ att[g]: each att element read once for the run
    if (VEC) {
      const int D4 = D / 4;
      for (int d = tid; d < D4; d += kAttThreads) {
        float4 acc[QMAX];
#pragma unroll
        for (int q = 0; q < QMAX; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j0 = 0; j0 < N; j0 += kAttLoads) {
          float4 a[kAttLoads];   // kAttLoads loads of att in flight
#pragma unroll
          for (int u = 0; u < kAttLoads; ++u)
            a[u] = j0 + u < N ? ldg4(ag + (size_t)(j0 + u) * D + 4 * d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < kAttLoads; ++u) {
            if (j0 + u >= N) break;
#pragma unroll
            for (int q = 0; q < QMAX; ++q) {
              if (qa + q >= qb) break;
              const float wj = e_s[(qa + q) * N + j0 + u];
              acc[q].x = fmaf(wj, a[u].x, acc[q].x);
              acc[q].y = fmaf(wj, a[u].y, acc[q].y);
              acc[q].z = fmaf(wj, a[u].z, acc[q].z);
              acc[q].w = fmaf(wj, a[u].w, acc[q].w);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          if (qa + q >= qb) break;
          reinterpret_cast<float4*>(out + (q0 + qa + q) * D)[d] = acc[q];
        }
      }
    } else {
      for (int d = tid; d < D; d += kAttThreads) {
        float acc[QMAX];
#pragma unroll
        for (int q = 0; q < QMAX; ++q) acc[q] = 0.f;
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
          const float a = ldg1(ag + (size_t)j * D + d);
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (qa + q >= qb) break;
            acc[q] = fmaf(e_s[(qa + q) * N + j], a, acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          if (qa + q >= qb) break;
          out[(q0 + qa + q) * D + d] = acc[q];
        }
      }
    }
    __syncthreads();   // p_s and the barriers are free for the next run
    parity ^= 1;
    r0 = r1;
  }
}

// Whether a launch can take the VEC path: a p_att row is a whole number of
// 16-byte bulk-copy units, att rows split into aligned groups of 4 values,
// out stores float4s.
template <typename T>
bool attend_vec(const T* p_att, const T* att, const float* out, int H,
                int D) {
  return (size_t)H * sizeof(T) % 16 == 0 && D % 4 == 0 && aligned16(p_att) &&
         aligned(att, 4 * sizeof(T)) && aligned16(out);
}

template <typename T, bool ROUND, int QMAX>
cudaError_t launch_attend_q(const T* p_att, const T* att, const float* mask,
                            const int* idx, const float* part,
                            const float* bh, const T* v, const float* bv,
                            float* out, float* w, int S, int B, int G, int N,
                            int H, int D, int splits, int rpb,
                            cudaStream_t st) {
  const bool vec = attend_vec(p_att, att, out, H, D);
  const size_t smem = attend_smem(QMAX, N, H, sizeof(T));
  const void* kernel = vec ? (const void*)attend_kernel<T, ROUND, QMAX, true>
                           : (const void*)attend_kernel<T, ROUND, QMAX, false>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + rpb - 1) / rpb);
  if (vec)
    attend_kernel<T, ROUND, QMAX, true><<<grid, kAttThreads, smem, st>>>(
        p_att, att, mask, idx, part, bh, v, bv, out, w, S, B, G, N, H, D,
        splits, rpb);
  else
    attend_kernel<T, ROUND, QMAX, false><<<grid, kAttThreads, smem, st>>>(
        p_att, att, mask, idx, part, bh, v, bv, out, w, S, B, G, N, H, D,
        splits, rpb);
  return cudaGetLastError();
}

template <typename T, bool ROUND>
cudaError_t launch_attend(const T* p_att, const T* att, const float* mask,
                          const int* idx, const float* part, const float* bh,
                          const T* v, const float* bv, float* out, float* w,
                          int S, int B, int G, int N, int H, int D,
                          int splits, int rpb, cudaStream_t st) {
  const int nq = rpb * B;
  if (rpb < 1 || nq > kMaxQueries) return cudaErrorInvalidValue;
#define SUBGC_ATTEND(QM)                                                     \
  if (nq <= QM)                                                              \
    return launch_attend_q<T, ROUND, QM>(p_att, att, mask, idx, part, bh, v, \
                                         bv, out, w, S, B, G, N, H, D,       \
                                         splits, rpb, st);
  SUBGC_ATTEND(1)
  SUBGC_ATTEND(2)
  SUBGC_ATTEND(4)
  SUBGC_ATTEND(8)
  SUBGC_ATTEND(16)
#undef SUBGC_ATTEND
  return cudaErrorInvalidValue;
}

// ---- the entries' bodies, one per storage dtype

template <typename T>
int project_entry(const T* h, const T* wh, const float* bh, float* part,
                  float* ah, int Q, int Hin, int H, int bm, int bn,
                  int splits, void* stream) {
  if (Q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_project(h, wh, part, Q, Hin, H, bm, bn, splits, st);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)Q * H;
  project_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, bh, ah, Q, H, splits);
  return (int)cudaGetLastError();
}

// ROUND: the shared bf16 rule (true only for bf16)
template <typename T, bool ROUND>
int shared_entry(const T* h, const T* p_att, const T* att, const float* mask,
                 const int* idx, const T* wh, const float* bh, const T* v,
                 const float* bv, float* part, float* out, float* w, int S,
                 int B, int R, int G, int N, int H, int D, int bm, int bn,
                 int splits, int rpb, void* stream) {
  if (S <= 0) return 0;
  if (G <= 0 || N <= 0 || R <= 0 || H <= 0 || D <= 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_project(h, wh, part, S * B, R, H, bm, bn, splits, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_attend<T, ROUND>(p_att, att, mask, idx, part, bh, v, bv,
                                      out, w, S, B, G, N, H, D, splits, rpb,
                                      st);
}

// one query per row, one row per block: the QMAX = 1 kernel, no rounding
template <typename T>
int row_entry(const T* h, const T* p_att, const T* att, const float* mask,
              const T* wh, const float* bh, const T* v, const float* bv,
              float* part, float* out, float* w, int R, int Hin, int N,
              int H, int D, int bm, int bn, int splits, void* stream) {
  if (R <= 0) return 0;
  if (Hin <= 0 || N <= 0 || H <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_project(h, wh, part, R, Hin, H, bm, bn, splits, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_attend_q<T, false, 1>(p_att, att, mask, nullptr, part,
                                           bh, v, bv, out, w, R, 1, R, N, H,
                                           D, splits, 1, st);
}

}  // namespace

// Every entry returns a cudaError_t (0 on success).  All pointers are device
// pointers to contiguous arrays: float32, or in the *_bf16 entries bfloat16
// for h, p_att, att, wh and v (idx: int32; bh, bv, mask and every output
// float32); stream is a cudaStream_t.  The plan (bm x bn tiles from
// {32, 64, 128} x {64, 128}, splits with no empty split, rows per block with
// rows x beams <= 16) comes from subgc_tpu_torch/ops/attention.py; part is
// the [splits, Q, H] float32 scratch.

// ah [Q, H] = h [Q, Hin] @ wh [Hin, H] + bh: the projection stage alone.
extern "C" int subgc_attention_project_f32(const float* h, const float* wh,
                                           const float* bh, float* part,
                                           float* ah, int Q, int Hin, int H,
                                           int bm, int bn, int splits,
                                           void* stream) {
  return project_entry(h, wh, bh, part, ah, Q, Hin, H, bm, bn, splits,
                       stream);
}

extern "C" int subgc_attention_project_bf16(const bf16* h, const bf16* wh,
                                            const float* bh, float* part,
                                            float* ah, int Q, int Hin, int H,
                                            int bm, int bn, int splits,
                                            void* stream) {
  return project_entry(h, wh, bh, part, ah, Q, Hin, H, bm, bn, splits,
                       stream);
}

// h [S, B, R], p_att [G, N, H], att [G, N, D], mask [S, N], idx [S],
// wh [R, H], bh [H], v [H, 1], bv [1] -> out [S, B, D], w [S, B, N].
extern "C" int subgc_shared_attention_f32(
    const float* h, const float* p_att, const float* att, const float* mask,
    const int* idx, const float* wh, const float* bh, const float* v,
    const float* bv, float* part, float* out, float* w, int S, int B, int R,
    int G, int N, int H, int D, int bm, int bn, int splits, int rpb,
    void* stream) {
  return shared_entry<float, false>(h, p_att, att, mask, idx, wh, bh, v, bv,
                                    part, out, w, S, B, R, G, N, H, D, bm, bn,
                                    splits, rpb, stream);
}

extern "C" int subgc_shared_attention_bf16(
    const bf16* h, const bf16* p_att, const bf16* att, const float* mask,
    const int* idx, const bf16* wh, const float* bh, const bf16* v,
    const float* bv, float* part, float* out, float* w, int S, int B, int R,
    int G, int N, int H, int D, int bm, int bn, int splits, int rpb,
    void* stream) {
  return shared_entry<bf16, true>(h, p_att, att, mask, idx, wh, bh, v, bv,
                                  part, out, w, S, B, R, G, N, H, D, bm, bn,
                                  splits, rpb, stream);
}

// h [R, Hin], p_att [R, N, H], att [R, N, D], mask [R, N], wh [Hin, H],
// bh [H], v [H, 1], bv [1] -> out [R, D], w [R, N]; row r reads stream r.
extern "C" int subgc_row_attention_f32(
    const float* h, const float* p_att, const float* att, const float* mask,
    const float* wh, const float* bh, const float* v, const float* bv,
    float* part, float* out, float* w, int R, int Hin, int N, int H, int D,
    int bm, int bn, int splits, void* stream) {
  return row_entry(h, p_att, att, mask, wh, bh, v, bv, part, out, w, R, Hin,
                   N, H, D, bm, bn, splits, stream);
}

extern "C" int subgc_row_attention_bf16(
    const bf16* h, const bf16* p_att, const bf16* att, const float* mask,
    const bf16* wh, const float* bh, const bf16* v, const float* bv,
    float* part, float* out, float* w, int R, int Hin, int N, int H, int D,
    int bm, int bn, int splits, void* stream) {
  return row_entry(h, p_att, att, mask, wh, bh, v, bv, part, out, w, R, Hin,
                   N, H, D, bm, bn, splits, stream);
}
