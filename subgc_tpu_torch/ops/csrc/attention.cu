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
// bound for the same work is set by bytes, well under a microsecond at the
// decode's shapes: what bounds the bf16 entries is latency, a chain of
// global-memory round trips in each stage and the launch between them.
// Measured on an H100 (PERF.md) the two stages of the earlier bf16 design
// took about equal shares of ~0.05 ms, plus ~5 us between the launches; its
// projection, the float32 SGEMM fed bf16 slices through registers, was
// slower than the float32 one.
//
// Design.
// 1. project_kernel (float32): a SIMT SGEMM.  A block owns a BM x BN tile
//    of the queries' projections; the k-slices of h and wh pass through a
//    ring of kStages shared-memory stages, so the next slices load while the
//    block multiplies the current one.  The slices are filled by cp.async
//    (16-byte copies where rows are 16-byte aligned, else 4-byte).  Each
//    thread keeps an 8 x 4 register tile: per four k it reads 8 + 4 float4s
//    from shared memory for 128 multiply-adds.  wh is read from L2 once per
//    BM queries, not once per block of 4 queries.  Where the tiles alone
//    would not give ~2 blocks per SM, k is split over gridDim.z and each
//    split writes its partial sums to a [splits, Q, H] scratch; the
//    consumer adds them in split order (no atomics: the result does not
//    depend on block order).
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
//    of the weighted sum over att (8 in bf16), keeps 8 loads of att (16
//    bytes each) in flight and reads each att element once for all queries
//    of the run.  Rows with streams of their own are one row per block; in
//    the image-shared layouts a block takes up to 16 queries.
// 3. The bf16 entries: the projection runs on the tensor cores in
//    project_tc_kernel: the h and wh slices stay bf16 in a 4-stage
//    shared-memory ring filled by 16-byte cp.async copies (3 slices in
//    flight), ldmatrix feeds mma.m16n8k16 with float32 accumulators (exact
//    bf16 products summed in float32, as the MXU's float32-accumulated dot
//    in the Pallas body), and k is split into the same [splits, Q, H]
//    scratch.  attend_kernel is launched as a programmatic dependent of it
//    (its blocks set up while the projection runs and wait,
//    griddepcontrol.wait, only before they read the partial sums), loads
//    each thread's partials all at once instead of one split after the
//    other, reads p_att from shared memory and att from global memory 8
//    bf16 values (16 bytes) a load with 16 loads in flight, and where the
//    grid leaves each block an SM of its own (Full_GC_Kar's one row, a
//    serving dispatch) runs 512 threads a block.  Measured (PERF.md): the
//    attention kernel is then ~3/4 of the entry, its tanh phase the
//    largest part; a tanh table in shared memory (exact by construction)
//    was slower than tanhf there.
// Plain tanhf/expf, no fast math.
//
// Measured on an H100 (PERF.md): the float32 attention stage is bound by
// the latency of its serial phases more than by tanhf; there an L2
// prefetch of att during the tanh phase, and starting the first stream copy
// before the partial sums, were both slower and are not used.

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
// aligned).  ldg4 reads through the read-only path (global memory only),
// lds4 plainly (shared memory).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) { return to_float(*p); }

// 8 consecutive bf16 values (one 16-byte word, 16-byte aligned) as floats
__device__ __forceinline__ void unpack8(uint4 u, float* x) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = bf16_bits(w[i] & 0xffffu);
    x[2 * i + 1] = bf16_bits(w[i] >> 16);
  }
}

// tanh of a logit term: in the shared bf16 rule the add and the tanh each
// round to bfloat16 (p and ah are bf16 values already); else float32.
template <bool ROUND>
__device__ __forceinline__ float act(float x) {
  return ROUND ? round_bf16(tanhf(round_bf16(x))) : tanhf(x);
}

// ah[i] = (sum over z < splits of part[z * stride + i], in split order) +
// bh[i % H], i < n, rounded once in the shared bf16 rule: each thread keeps
// the loads of 4 elements x 8 splits in flight (the loop that adds one
// split at a time waits for each load in turn)
template <bool ROUND>
__device__ __forceinline__ void sum_partials(float* ah, const float* part,
                                             const float* bh, int n, int H,
                                             size_t stride, int splits) {
  constexpr int E = 4, Z = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += E * blockDim.x) {
    float a[E];
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = -0.f;   // -0 + x == x
    for (int z0 = 0; z0 < splits; z0 += Z) {
      float x[E][Z];
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int z = 0; z < Z; ++z) {
          const int i = i0 + e * blockDim.x;
          x[e][z] = i < n && z0 + z < splits ? part[(z0 + z) * stride + i]
                                             : 0.f;
        }
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int z = 0; z < Z; ++z)
          if (z0 + z < splits) a[e] += x[e][z];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + e * blockDim.x;
      if (i < n) {
        const float v = a[e] + bh[i % H];
        ah[i] = ROUND ? round_bf16(v) : v;
      }
    }
  }
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

// bytes in [0, 16]; dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tensor cores (bf16 in, float32 accumulators)
// four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i (16-byte aligned)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16 x 8] += a[16 x 16] b[16 x 8]: exact bf16 products, float32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- programmatic dependent launch: the attention kernel of the bf16
// entries starts while the projection runs and waits for its results here
// (both are no-ops for a kernel launched the ordinary way)
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

// TIn: float (the bf16 entries project on the tensor cores instead:
// project_tc_kernel below).
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
      static_assert(std::is_same<TIn, float>::value,
                    "bf16 projects in project_tc_kernel");
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

// ---- the bf16 projection on the tensor cores
//
// part[z, q, :] = h[q, kz] @ wh[kz, :] as project_kernel forms it, with h and
// wh bf16: a block of 4 warps owns a BM x BN tile; the k-slices of h
// ([BM][kBKt]) and wh ([kBKt][BN]) stay bf16 in a ring of kStagesT
// shared-memory stages filled by cp.async (16-byte copies, 8 values, where
// rows are 16-byte aligned; else value by value through registers), so
// kStagesT - 1 slices are in flight while the warps multiply one.  Each warp
// owns a WTM x WTN sub-tile: ldmatrix feeds mma.m16n8k16 (bf16 in, float32
// accumulators in registers).  k is split over gridDim.z as in float32.

constexpr int kBKt = 32;        // k per ring slice (two mma k-steps)
constexpr int kStagesT = 4;     // slices in the ring
constexpr int kTcThreads = 128; // 4 warps
constexpr int kTcPad = 8;       // bf16 pad of a shared-memory row: ldmatrix's
                                // 8 row reads fall in 8 distinct bank groups

template <int BM, int BN>
struct TcTile {
  static constexpr int WM = BM >= 32 ? 2 : 1;   // warps over rows
  static constexpr int WN = 4 / WM;             // warps over columns
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;   // mma tiles a warp
  static constexpr int AS = kBKt + kTcPad;      // h slice row (bf16)
  static constexpr int BS = BN + kTcPad;        // wh slice row (bf16)
  static constexpr int A_ELEMS = BM * AS, B_ELEMS = kBKt * BS;
  static constexpr size_t SMEM =
      sizeof(bf16) * kStagesT * (size_t)(A_ELEMS + B_ELEMS);
  static_assert(MI >= 1 && NI % 2 == 0, "tile");
};

template <int BM, int BN>
__global__ void __launch_bounds__(kTcThreads)
project_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wh,
                  float* __restrict__ part, int Q, int Hin, int H,
                  int kchunk, int vec) {
  using TT = TcTile<BM, BN>;
  extern __shared__ float4 smem4[];
  bf16* As = reinterpret_cast<bf16*>(smem4);   // [kStagesT][BM][AS]
  bf16* Bs = As + kStagesT * TT::A_ELEMS;      // [kStagesT][kBKt][BS]

  // the dependent attention kernel may start now: it waits for this
  // grid's results before it reads them
  launch_dependents();

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / TT::WN, wn = warp % TT::WN;
  const int q0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(kb + kchunk, Hin);
  const int nk = (ke - kb + kBKt - 1) / kBKt;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);

  // slice t into stage st; what lies past Q, ke or H is zero
  auto load = [&](int t, int st) {
    const int k0 = kb + t * kBKt;
    bf16* as = As + st * TT::A_ELEMS;
    bf16* bs = Bs + st * TT::B_ELEMS;
    if (vec) {
#pragma unroll
      for (int i = tid; i < BM * kBKt / 8; i += kTcThreads) {
        const int r = i / (kBKt / 8);
        const int c = (i - r * (kBKt / 8)) * 8;
        const int q = q0 + r, k = k0 + c;
        const int valid = q < Q ? min(max(ke - k, 0), 8) : 0;
        cp_async16_bytes(as + r * TT::AS + c,
                         valid ? h + (size_t)q * Hin + k : h, 2 * valid);
      }
#pragma unroll
      for (int i = tid; i < kBKt * BN / 8; i += kTcThreads) {
        const int r = i / (BN / 8);
        const int c = (i - r * (BN / 8)) * 8;
        const int k = k0 + r, j = j0 + c;
        const int valid = k < ke ? min(max(H - j, 0), 8) : 0;
        cp_async16_bytes(bs + r * TT::BS + c,
                         valid ? wh + (size_t)k * H + j : wh, 2 * valid);
      }
    } else {
      // value by value: the stage of t - 1 is free (the __syncthreads
      // before this load) and the next __syncthreads publishes the stores
      for (int i = tid; i < BM * kBKt; i += kTcThreads) {
        const int r = i / kBKt;
        const int c = i - r * kBKt;
        const int q = q0 + r, k = k0 + c;
        as[r * TT::AS + c] = q < Q && k < ke ? h[(size_t)q * Hin + k] : zero;
      }
      for (int i = tid; i < kBKt * BN; i += kTcThreads) {
        const int r = i / BN;
        const int c = i - r * BN;
        const int k = k0 + r, j = j0 + c;
        bs[r * TT::BS + c] = k < ke && j < H ? wh[(size_t)k * H + j] : zero;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStagesT - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  float acc[TT::MI][TT::NI][4];
#pragma unroll
  for (int mi = 0; mi < TT::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TT::NI; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  // this lane's ldmatrix rows: h rows lane % 16 at k + 8 (lane / 16);
  // wh k-rows 8 (m & 1) + lane % 8 at columns + 8 (m / 2), m = lane / 8
  const int a_row = wm * TT::WTM + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_col = wn * TT::WTN + (lane >> 4) * 8;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStagesT - 2>();   // slice t has landed
    __syncthreads();                 // and every warp is done with t - 1
    const int tn = t + kStagesT - 1;
    if (tn < nk) load(tn, tn % kStagesT);   // into the stage of t - 1
    cp_async_commit();
    const bf16* as = As + (t % kStagesT) * TT::A_ELEMS;
    const bf16* bs = Bs + (t % kStagesT) * TT::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < kBKt; kk += 16) {
      uint32_t a[TT::MI][4], b[TT::NI][2];
#pragma unroll
      for (int mi = 0; mi < TT::MI; ++mi)
        ldmatrix_x4(a[mi], as + (a_row + mi * 16) * TT::AS + kk + a_col);
#pragma unroll
      for (int ni = 0; ni < TT::NI; ni += 2) {
        uint32_t x[4];
        ldmatrix_x4_trans(x, bs + (kk + b_row) * TT::BS + b_col + ni * 8);
        b[ni][0] = x[0];
        b[ni][1] = x[1];
        b[ni + 1][0] = x[2];
        b[ni + 1][1] = x[3];
      }
#pragma unroll
      for (int mi = 0; mi < TT::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TT::NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // accumulator c of tile (mi, ni): row lane / 4 (+ 8 for c >= 2), columns
  // 2 (lane % 4) + c % 2
  float* out = part + (size_t)blockIdx.z * Q * H;
#pragma unroll
  for (int mi = 0; mi < TT::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + wm * TT::WTM + mi * 16 + (lane >> 2) + half * 8;
      if (q >= Q) continue;
      float* orow = out + (size_t)q * H;
#pragma unroll
      for (int ni = 0; ni < TT::NI; ++ni) {
        const int j = j0 + wn * TT::WTN + ni * 8 + (lane & 3) * 2;
        const float x0 = acc[mi][ni][2 * half], x1 = acc[mi][ni][2 * half + 1];
        if (vec && j + 1 < H) {
          *reinterpret_cast<float2*>(orow + j) = make_float2(x0, x1);
        } else {
          if (j < H) orow[j] = x0;
          if (j + 1 < H) orow[j + 1] = x1;
        }
      }
    }
  }
}

// k per split of the bf16 projection: whole ring slices
int project_tc_chunk(int Hin, int splits) {
  const int slices = (Hin + kBKt - 1) / kBKt;
  return (slices + splits - 1) / splits * kBKt;
}

template <int BM, int BN>
cudaError_t launch_project_tc_tile(const bf16* h, const bf16* wh,
                                   float* part, int Q, int Hin, int H,
                                   int splits, int vec, cudaStream_t st) {
  using TT = TcTile<BM, BN>;
  const cudaError_t err =
      set_smem((const void*)project_tc_kernel<BM, BN>, TT::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + BM - 1) / BM, (H + BN - 1) / BN, splits);
  project_tc_kernel<BM, BN><<<grid, kTcThreads, TT::SMEM, st>>>(
      h, wh, part, Q, Hin, H, project_tc_chunk(Hin, splits), vec);
  return cudaGetLastError();
}

// vec: rows of 8 values copy whole (16-byte cp.async) and part stores
// float2s.  Tiles bm x bn from {16, 32, 64, 128} x {64, 128}.
cudaError_t launch_project_tc(const bf16* h, const bf16* wh, float* part,
                              int Q, int Hin, int H, int bm, int bn,
                              int splits, cudaStream_t st) {
  if (Hin <= 0 || H <= 0 || splits < 1 ||
      (splits - 1) * project_tc_chunk(Hin, splits) >= Hin)
    return cudaErrorInvalidValue;   // an empty split
  const int vec = Hin % 8 == 0 && H % 8 == 0 && aligned16(h) &&
                  aligned16(wh) && aligned16(part);
#define SUBGC_TC_TILE(M, N)                                                  \
  if (bm == M && bn == N)                                                    \
    return launch_project_tc_tile<M, N>(h, wh, part, Q, Hin, H, splits, vec, \
                                        st);
  SUBGC_TC_TILE(16, 64)
  SUBGC_TC_TILE(32, 64)
  SUBGC_TC_TILE(64, 64)
  SUBGC_TC_TILE(128, 64)
  SUBGC_TC_TILE(16, 128)
  SUBGC_TC_TILE(32, 128)
  SUBGC_TC_TILE(64, 128)
  SUBGC_TC_TILE(128, 128)
#undef SUBGC_TC_TILE
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
// row kernel's bf16 streams.  VEC: p_att goes by bulk copy and att by 16
// bytes a load (float32: 4 values, bf16: 8; H a multiple of 16 bytes'
// worth, D of 4 or 8, the streams and out aligned).  idx == nullptr: row s
// reads stream s.  In bf16 the kernel is launched as a programmatic
// dependent of the projection: it sets up before it waits for the partial
// sums, which it then loads all at once.  NT: threads of the block (the
// bf16 launcher doubles them where each block has an SM to itself).
template <typename T, bool ROUND, int QMAX, bool VEC, int NT = kAttThreads>
__global__ void __launch_bounds__(NT)
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
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // this instantiation's block size (shadows the default)
  constexpr int kAttThreads = NT;
  constexpr int kAttWarps = NT / 32;
  constexpr bool WIDE = kBf16 && VEC;    // 8 bf16 values (16 bytes) a load

  if (tid < rows) {
    // out-of-range stream indices clamp, as the JAX gather does
    const int g = idx ? idx[s0 + tid] : s0 + tid;
    g_s[tid] = min(max(g, 0), G - 1);
  }
  if (VEC && tid == 0) {
    for (int c = 0; c < nch; ++c) mbar_init(bar + c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kBf16) {
    grid_dependency_wait();   // the projection's partials are whole
    sum_partials<ROUND>(ah_s, part + q0 * H, bh, nq * H, H, Q * H, splits);
  } else
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
      if constexpr (WIDE) {
        // bf16: 8 values (16 bytes) of p a lane
        for (int c = lane * 8; c < H; c += 256) {
          float p[8];
          unpack8(*reinterpret_cast<const uint4*>(pr + c), p);
          const float4 v0 = *reinterpret_cast<const float4*>(v_s + c);
          const float4 v1 = *reinterpret_cast<const float4*>(v_s + c + 4);
          const float vc[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (qa + q >= qb) break;
            const float* aq = ah_s + (qa + q) * H + c;
            const float4 a0 = *reinterpret_cast<const float4*>(aq);
            const float4 a1 = *reinterpret_cast<const float4*>(aq + 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            float s = sum[q];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              s = fmaf(act<ROUND>(p[u] + a[u]), vc[u], s);
            sum[q] = s;
          }
        }
      } else if constexpr (VEC) {
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
    if constexpr (WIDE) {
      // bf16: 8 values (16 bytes) of att a load, more loads in flight
      // where few queries leave registers for them
      constexpr int L = QMAX <= 4 ? 2 * kAttLoads : kAttLoads;
      const int D8 = D / 8;
      for (int d = tid; d < D8; d += kAttThreads) {
        float acc[QMAX][8];
#pragma unroll
        for (int q = 0; q < QMAX; ++q)
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[q][u] = 0.f;
        for (int j0 = 0; j0 < N; j0 += L) {
          uint4 a[L];
#pragma unroll
          for (int u = 0; u < L; ++u)
            a[u] = j0 + u < N ? __ldg(reinterpret_cast<const uint4*>(
                                    ag + (size_t)(j0 + u) * D) + d)
                              : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < L; ++u) {
            if (j0 + u >= N) break;
            float x[8];
            unpack8(a[u], x);
#pragma unroll
            for (int q = 0; q < QMAX; ++q) {
              if (qa + q >= qb) break;
              const float wj = e_s[(qa + q) * N + j0 + u];
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[q][i] = fmaf(wj, x[i], acc[q][i]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          if (qa + q >= qb) break;
          float4* o =
              reinterpret_cast<float4*>(out + (q0 + qa + q) * D) + 2 * d;
          o[0] = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
          o[1] = make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
        }
      }
    } else if constexpr (VEC) {
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
// 16-byte bulk-copy units, att rows split into aligned 16-byte groups (4
// float32 or 8 bf16 values), out stores float4s.
template <typename T>
bool attend_vec(const T* p_att, const T* att, const float* out, int H,
                int D) {
  if constexpr (std::is_same<T, bf16>::value)
    return H % 8 == 0 && D % 8 == 0 && aligned16(p_att) && aligned16(att) &&
           aligned16(out);
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
  if constexpr (std::is_same<T, bf16>::value) {
    // a programmatic dependent of the projection launched just before it.
    // A block of at most 4 queries takes twice the threads where the grid
    // leaves each block an SM of its own (two such blocks do not fit on
    // one): its warps then take half the serial rounds.
    constexpr int kWide = 2 * kAttThreads;
    bool wide = false;
    if constexpr (QMAX <= 4) {
      int dev = 0, sms = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      wide = vec && (int)grid.x <= sms;
      if (wide) {
        e = set_smem((const void*)attend_kernel<T, ROUND, QMAX, true, kWide>,
                     smem);
        if (e != cudaSuccess) return e;
      }
    }
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(wide ? kWide : kAttThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    auto launch = [&](auto kernel) {
      return cudaLaunchKernelEx(&cfg, kernel, p_att, att, mask, idx, part, bh,
                                v, bv, out, w, S, B, G, N, H, D, splits, rpb);
    };
    if constexpr (QMAX <= 4) {
      if (wide) return launch(attend_kernel<T, ROUND, QMAX, true, kWide>);
    }
    return vec ? launch(attend_kernel<T, ROUND, QMAX, true>)
               : launch(attend_kernel<T, ROUND, QMAX, false>);
  }
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

// the projection stage: float32 on the CUDA cores, bf16 on the tensor cores
cudaError_t launch_projection(const float* h, const float* wh, float* part,
                              int Q, int Hin, int H, int bm, int bn,
                              int splits, cudaStream_t st) {
  return launch_project(h, wh, part, Q, Hin, H, bm, bn, splits, st);
}

cudaError_t launch_projection(const bf16* h, const bf16* wh, float* part,
                              int Q, int Hin, int H, int bm, int bn,
                              int splits, cudaStream_t st) {
  return launch_project_tc(h, wh, part, Q, Hin, H, bm, bn, splits, st);
}

template <typename T>
int project_entry(const T* h, const T* wh, const float* bh, float* part,
                  float* ah, int Q, int Hin, int H, int bm, int bn,
                  int splits, void* stream) {
  if (Q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch_projection(h, wh, part, Q, Hin, H, bm, bn, splits, st);
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
      launch_projection(h, wh, part, S * B, R, H, bm, bn, splits, st);
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
  cudaError_t err =
      launch_projection(h, wh, part, R, Hin, H, bm, bn, splits, st);
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
// {32, 64, 128} x {64, 128} in float32, {16, 32, 64, 128} x {64, 128} in
// bf16; splits of whole 16-k (float32) or 32-k (bf16) slices with no empty
// split; rows per block with rows x beams <= 16) comes from
// subgc_tpu_torch/ops/attention.py; part is the [splits, Q, H] float32
// scratch.

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
