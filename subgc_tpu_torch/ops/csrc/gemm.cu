// Float32 products on Hopper's tensor cores at float32 accuracy: split
// TF32 ("3xTF32"), for the decoder's step products (models/decoder.py::
// decode_step: the two LSTMs' input and recurrent products and the logit).
//
// It replaces no TPU kernel.  The JAX package leaves these products to XLA;
// the port first left them to torch.matmul, which on the H100 runs float32
// products in full float32 on the CUDA cores (cuBLAS's SIMT sgemm, 67
// TFLOP/s peak, 44-47 measured at the M-RNN decode's shapes, PERF.md).
// TF32 alone keeps about three decimal digits and breaks the float32
// contract; split TF32 keeps it.
//
//   C[M, N] = A[M, K] @ B[K, N] (+ bias[N])
//   each operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
//   (cvt.rna: round to nearest, ties away from zero)
//   A B ~ hi_A hi_B + lo_A hi_B + hi_A lo_B, float32 accumulators
//
// The dropped lo_A lo_B and the rounding of lo are each below 2^-22 of
// a product, so the result keeps float32's accuracy: at K = 1000 its error
// is that of a float32 sum (tests/test_torch_port_split_gemm.py holds the
// plain version, ops/gemm.py::split_gemm_ref, and this kernel to it).  The
// tensor cores' float32 sums do not round to nearest, and one accumulator
// over K = 1,000 lost accuracy in proportion to K; so each 32-k slice sums
// its 4 k-steps x 3 products (hi hi, lo hi, hi lo a k-step) on the tensor
// cores from zero, and the slices' sums are added in k order in registers
// with round-to-nearest float32 adds.  The bias joins after the sum, as
// torch's x @ w + b rounds it.
//
// Two kernels:
// * split_tf32_weight_prep_kernel splits B once and writes it K-major, as
//   two planes [2, N, Kp] (hi, lo; Kp = K rounded up to 4, zero-padded, so
//   that a row is a multiple of 16 bytes as TMA asks).  The decode is
//   weight-stationary: its seven weights serve every step of a call, so
//   the decoder prepares them once a call (decoder.py::SplitWeights).
// * split_tf32_gemm_kernel multiplies float32 A by the prepared B.
//
// What bounds it on an H100 (700 W).  At the M-RNN decode's kept rows (M
// ~4,860, K = 1,000, N = 4,000 or 9,488) the card's bound is operations:
// 2 M N K at 495 TFLOP/s TF32 is 0.079 and 0.19 ms, the three passes 3x
// that (0.236 and 0.56 ms).  The kernel this one replaces (one producer
// warpgroup loading float32 A and B with plain loads, splitting both and
// transposing B in registers, storing swizzled hi/lo tiles for two
// consumer warpgroups) ran 0.676 ms at N = 4,000 (57.5 TFLOP/s counted as
// 2 M N K); its producer set the pace: skipping its split and stores took
// it to 0.513 ms, skipping the consumers' wgmma only to 0.551 (PERF.md).
// Its every weight tile was split and transposed again for each of 38 row
// blocks.  This design:
// * Splits the weight once a decode call, not once a tile.
// * Feeds a 4-stage ring with TMA: one producer thread issues, per 32-k
//   slice, float32 A [128 x 32] and B's hi and lo planes [128 x 32] each
//   (one 3-d box), all with the 128-byte swizzle, completed on an mbarrier
//   by byte count.  Ragged edges (rows past M, columns past N, k past K)
//   arrive as TMA's zero fill.  The producer warpgroup keeps 40
//   registers, the consumers 232 (setmaxnreg).
// * Splits A in the consumers' registers: each consumer warpgroup (rows
//   0-63 or 64-127 of a 128 x 128 tile) reads its rows of the float32
//   slice from shared memory once (the swizzle makes the reads
//   conflict-free), splits them with cvt.rna and issues wgmma m64n128k8
//   with A from registers and B's planes from shared memory.  A slice
//   moves 48 KB by TMA and reads 16 KB of A and 96 KB of B out of shared
//   memory, within the SM's 128 bytes a cycle at the tensor cores' pace.
// * Walks the tiles with a persistent grid (one block an SM), M-fastest:
//   the blocks running at once share a few columns of B, and A (~19 MB at
//   4,860 rows) stays in L2 across the column blocks.  Each consumer
//   drains its own wgmma group; the two warpgroups run unsynchronised, so
//   one's products are in the tensor cores while the other adds its slice
//   or stores its tile.
// Measured at M = 4,864, N = 4,000: 0.343 ms (113 TFLOP/s, 69% of the
// three passes' bound); the logit (N = 9,488) 0.80 ms.  Its loads then
// come to ~1.8-1.9 GB a product, ~5.4 TB/s if all of them come from L2;
// that is bytes over time, not a measured L2 throughput, so what bounds
// the kernel now is open (the cluster below, which halves B's L2 reads,
// ran slower).  Tried and left out, each timed against this design in
// one run: explicit turns between the two consumer warpgroups (named
// barriers; 0.417-0.430 ms against 0.410), a two-block cluster sharing
// B's loads by TMA multicast (0.69-0.72 ms: the blocks' coupled rings
// stall each other, with or without the multicast), 128 x 160 tiles
// (0.372-0.421 against 0.394-0.399).  One launch a product.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBK = 32;        // k per stage: one 128-byte swizzled row
constexpr int kBM = 128;       // two consumer warpgroups of 64 rows
constexpr int kBN = 128;
constexpr int kStages = 4;     // slices in the shared-memory ring
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kABytes = kBM * kBK * 4;        // float32 A slice: 16 KB
constexpr int kBBytes = kBN * kBK * 4;        // one plane of B: 16 KB
constexpr int kStageBytes = kABytes + 2 * kBBytes;
// stages, 1,024 bytes of alignment slack, then the 2 kStages mbarriers
constexpr size_t kSmem = kStages * kStageBytes + 1024 +
                         2 * kStages * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// float32 -> tf32 bits (low 13 bits zero), round to nearest, ties away
// from zero; ops/gemm.py::tf32_round is its plain version.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// shared address saddr: start >> 4, leading offset 1 (unused when the
// swizzle holds the k-step), 1,024 bytes between 8-row groups, swizzle
// mode 1 (128 bytes).  A k-step of 8 tf32 (32 bytes) adds 2.
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of registers that an
// asynchronous wgmma owns (its accumulators and its A fragment) across it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128]: A tf32 from registers (this
// thread's fragment: rows r, r + 8, columns c, c + 4 of the k-step, r =
// 16 warp + lane / 4, c = lane % 4), B tf32 K-major from shared memory
// (128-byte swizzle), float32 accumulators; scale_d 0 starts D at zero.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
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

// TMA: a box of the tensor map at coordinates (innermost first) into
// shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// One block an SM, persistent: block b takes tiles b, b + gridDim.x, ...
// of the walk, tile u being column block u / rows and row block u % rows
// (rows = row blocks), so that the blocks running at once share B's
// columns.
__global__ void __launch_bounds__(kThreads, 1)
split_tf32_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                       const __grid_constant__ CUtensorMap tma_b,
                       const float* __restrict__ bias, float* __restrict__ C_,
                       int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // full[s]: the slice's bytes have landed in stage s; empty[s]: both
  // consumer warpgroups are done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int slices = (K + kBK - 1) / kBK;
  const int rows = (M + kBM - 1) / kBM;
  const int tiles = rows * ((N + kBN - 1) / kBN);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      uint32_t it = 0;
      for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        const int n0 = (u / rows) * kBN, m0 = (u % rows) * kBM;
        for (int t = 0; t < slices; ++t, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
          uint8_t* st = smem + s * kStageBytes;
          mbar_expect(full + s, kStageBytes);
          tma_load_2d(st, &tma_a, full + s, t * kBK, m0);
          tma_load_3d(st + kABytes, &tma_b, full + s, t * kBK, n0, 0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // consumer warpgroup c: rows 64 c .. 64 c + 63 of each tile.  part: one
    // slice's sum on the tensor cores; acc: the running sum, in the same
    // layout, added to with round-to-nearest float32 adds
    const int c = wg - 1;
    const int lane = tid & 31;
    const int wr = 64 * c + 16 * ((tid & 127) >> 5) + (lane >> 2);
    float part[64], acc[64];
    uint32_t it = 0;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const int n0 = (u / rows) * kBN, m0 = (u % rows) * kBM;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int t = 0; t < slices; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        const uint8_t* st = smem + s * kStageBytes;
        // this thread's A fragment of the four k-steps, split: element
        // 4 kk + j is row wr + 8 (j & 1), column 8 kk + 4 (j >> 1) + lane % 4,
        // in 16-byte chunk 2 kk + (j >> 1) of its swizzled row
        uint32_t ah[16], al[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = wr + 8 * (i & 1);
          const int q = (i >> 1);                       // chunk 2 kk + j / 2
          const float v = *reinterpret_cast<const float*>(
              st + r * 128 + ((q ^ (r & 7)) << 4) + 4 * (lane & 3));
          ah[i] = tf32_bits(v);
          al[i] = tf32_bits(v - __uint_as_float(ah[i]));
        }
        const uint32_t sb = smem_addr(st + kABytes);
        const uint64_t b_hi = smem_desc(sb);
        const uint64_t b_lo = smem_desc(sb + kBBytes);
        fence_regs(ah);
        fence_regs(al);
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          wgmma_rs(part, ah + 4 * kk, b_hi + 2 * kk, kk > 0);
          wgmma_rs(part, al + 4 * kk, b_hi + 2 * kk, 1);
          wgmma_rs(part, ah + 4 * kk, b_lo + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
        fence_regs(ah);
        fence_regs(al);
        if ((tid & 127) == 0) mbar_arrive(empty + s);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }

      // accumulator layout of m64n128: warp w of the warpgroup holds rows
      // 16 w + lane / 4 (+ 8); register 4 j + {0, 1} columns 8 j + 2
      // (lane % 4) + {0, 1}, 4 j + {2, 3} the same columns 8 rows down
      const int row = m0 + wr;
      const bool pairs = (N & 1) == 0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= N) continue;
        const bool two = col + 1 < N;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          b0 = __ldg(bias + col);
          if (two) b1 = __ldg(bias + col + 1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r >= M) continue;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (bias != nullptr) {
            v0 += b0;
            v1 += b1;
          }
          float* p = C_ + (size_t)r * N + col;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (two) p[1] = v1;
          }
        }
      }
    }
  }
}

// planes[0][n][k] = tf32(w[k][n]), planes[1][n][k] = tf32(w[k][n] - that),
// zero for k in [K, kp): a 32 x 32 tile a block, transposed through shared
// memory so that both the reads (along n) and the writes (along k) are
// coalesced.
__global__ void __launch_bounds__(256)
split_tf32_weight_prep_kernel(const float* __restrict__ w,
                              float* __restrict__ planes, int K, int N,
                              int ldb, int kp) {
  __shared__ float hi[32][33], lo[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + ty + 8 * j, n = n0 + tx;
    const float v = (k < K && n < N) ? __ldg(w + (size_t)k * ldb + n) : 0.f;
    const float h = __uint_as_float(tf32_bits(v));
    hi[ty + 8 * j][tx] = h;
    lo[ty + 8 * j][tx] = __uint_as_float(tf32_bits(v - h));
  }
  __syncthreads();
  const size_t plane = (size_t)N * kp;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + ty + 8 * j, k = k0 + tx;
    if (n < N && k < kp) {
      planes[(size_t)n * kp + k] = hi[tx][ty + 8 * j];
      planes[plane + (size_t)n * kp + k] = lo[tx][ty + 8 * j];
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A float32 tensor map with the 128-byte swizzle: dims and boxes innermost
// first, strides in bytes of every dim but the innermost.  0, or an error:
// cudaErrorNotSupported without the entry point, else the encoder's
// CUresult, negated.
int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// The current device's SM count (the persistent grid), with the kernel's
// shared memory admitted there, once a device; 0 on an error.
int prepare_device() {
  static int sms[64] = {0};
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(split_tf32_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem) != cudaSuccess)
      return 0;
    sms[dev] = n;
  }
  return sms[dev];
}

}  // namespace

// Prepare w [K, N] (rows ldb apart) for the kernel: planes [2, N, kp]
// (hi, lo), kp >= K a multiple of 4, written on the given stream of the
// current device, and B's tensor map of them into map_out (128 bytes,
// kept by the caller and passed to subgc_split_gemm_f32).  At K or N = 0
// there is nothing to write: it launches nothing and leaves map_out as it
// is.  Returns 0 or an error (cudaError_t, or a negated CUresult).
extern "C" int subgc_split_prep_f32(const float* w, float* planes, int K,
                                    int N, int ldb, int kp, void* map_out,
                                    void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaSuccess;
  if (ldb < N || kp < K || kp % 4 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + 31) / 32, (kp + 31) / 32);
  split_tf32_weight_prep_kernel<<<grid, dim3(32, 8), 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      w, planes, K, N, ldb, kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)kp * 4,
                                 (cuuint64_t)kp * 4 * (cuuint64_t)N};
  const cuuint32_t box[3] = {kBK, kBN, 2};
  const int r = encode(&map, planes, 3, dims, strides, box);
  if (r != 0) return r;
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// C[M, N] = A[M, K] @ B (+ bias[N] unless null), float32, on the given
// stream of the current device: A rows lda apart (lda a multiple of 4, A
// 16-byte aligned), B the tensor map that subgc_split_prep_f32 made, C
// rows N apart.  At K = 0 the kernel loads no slice and reads neither map:
// it writes the bias, or zeros.  Returns 0 or an error (cudaError_t, or a
// negated CUresult).
extern "C" int subgc_split_gemm_f32(const float* A, int lda, const void* map_b,
                                    const float* bias, float* C, int M, int N,
                                    int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K < 0 || (K > 0 && (lda < K || lda % 4 != 0 ||
                          reinterpret_cast<uintptr_t>(A) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const int sms = prepare_device();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  alignas(64) CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  if (K > 0) {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)lda * 4};
    const cuuint32_t box[2] = {kBK, kBM};
    const int r = encode(&ma, A, 2, dims, strides, box);
    if (r != 0) return r;
  }
  memcpy(&mb, map_b, sizeof(mb));
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  split_tf32_gemm_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      ma, mb, bias, C, M, N, K);
  return (int)cudaGetLastError();
}
