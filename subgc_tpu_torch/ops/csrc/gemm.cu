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
//   C[M, N] = A[M, K] @ B[K, N] (+ bias[N])         A rows lda apart,
//                                                   B rows ldb apart
//   each operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
//   (cvt.rna: round to nearest, ties away from zero)
//   A B ~ hi_A hi_B + lo_A hi_B + hi_A lo_B, float32 accumulators
//
// The dropped lo_A lo_B and the rounding of lo are each below 2^-22 of
// a product, so the result keeps float32's accuracy: at K = 1000 its error
// is that of a float32 sum (tests/test_torch_port_split_gemm.py holds the
// plain version, ops/gemm.py::split_gemm_ref, and this kernel to it).  The
// bias joins in float32 after the sum, as torch's x @ w + b rounds it.
//
// What bounds it on an H100.  At the M-RNN decode's shapes (16,000 rows,
// K = 1,000, N = 4,000 or 9,488) the card's bound is operations: 2 M N K
// at 495 TFLOP/s TF32 is 0.26 and 0.61 ms, and the three passes take 3x
// that, 0.78 and 1.84 ms.  Below a few hundred rows it is reading B (16 or
// 38 MB) once; there the decoder keeps torch.matmul (decoder.py::
// SPLIT_GEMM_MIN_ROWS).  Measured (PERF.md), it runs 56-64 TFLOP/s
// counted as 2 M N K, a third of what the three passes allow.
//
// Design.
// * wgmma m64nBNk8 tf32, both operands K-major in shared memory with the
//   128-byte swizzle: a k-slice of 32 float32 is one 128-byte row per
//   matrix row.  A block is one producer warpgroup and C consumer
//   warpgroups; it owns a (64 C) x BN tile of the output, and consumer c
//   multiplies rows 64 c .. 64 c + 63 of it against the whole BN-column
//   slice of B.
// * The producer reads every element of A and B once per tile from device
//   memory, as float32 (16-byte loads where rows allow), splits it into hi
//   and lo in registers and stores both to a stage of a 3-stage
//   shared-memory ring, handing each stage to the consumers through an
//   mbarrier (generic-proxy stores reach wgmma through fence.proxy.async)
//   and taking it back through another: the split costs no bytes of device
//   memory, and the next slices load while the tensor cores run this one.
// * B stays as the model stores it, [K, N] (x @ w), and is transposed on
//   its way through the producer's registers: a thread loads four k-rows
//   of four columns and stores each column's four k as one 16-byte chunk
//   of the K-major tile.  Its lanes are placed so that each 8-lane phase
//   of a store meets the 8 chunk positions of the swizzle once (no bank
//   conflict) and each load reads 128 contiguous bytes of a k-row.
// * The tensor cores' float32 sums do not round to nearest: summing all
//   of K = 1,000 in the wgmma accumulator lost accuracy in proportion to
//   K (several times cuBLAS's float32 error).  So each k-slice sums its
//   4 k-steps x 3 products on the tensor cores from zero, and the slices'
//   sums are added in registers with round-to-nearest float32 adds.
// * Ragged edges: rows of A past M, columns of B past N and k past K load
//   as zeros; the epilogue stores only rows < M and columns < N (two
//   floats a store where N is even).  One launch per product.
// * One tile, 128 x 128 (two consumer warpgroups, each holding a slice's
//   sum and the running sum, 64 floats apiece); the decoder sends it
//   1,000 rows or more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;        // k per stage: one 128-byte swizzled row
constexpr int kStages = 3;     // slices in the shared-memory ring
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

// float32 -> tf32 (low 13 bits zero), round to nearest, ties away from
// zero; ops/gemm.py::tf32_round is its plain version.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Byte offset of the 16-byte chunk q (0..7) of row r in a K-major tile
// with the 128-byte swizzle: 128 bytes a row, chunks XORed with r mod 8
// within each 1,024-byte group of 8 rows (tiles start 1,024-aligned).
__device__ __forceinline__ uint32_t swizzled(int r, int q) {
  return (uint32_t)(r * 128 + ((q ^ (r & 7)) << 4));
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across the
// asynchronous wgmma that own them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 8] B[8 x 128], tf32 operands read from shared memory
// (both K-major, 128-byte swizzle), float32 accumulators; scale_d 0
// starts D at zero.
__device__ __forceinline__ void wgmma_k8(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// The 16-byte chunk of row `row`, columns k .. k + 3, of a row-major
// [rows, K] operand with rows ld apart; zeros past rows and K.
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ base,
                                             int row, int rows, int ld,
                                             int k, int K, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows || k >= K) return v;
  const float* p = base + (size_t)row * ld + k;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = __ldg(p);
  if (k + 1 < K) v.y = __ldg(p + 1);
  if (k + 2 < K) v.z = __ldg(p + 2);
  if (k + 3 < K) v.w = __ldg(p + 3);
  return v;
}

// Columns n .. n + 3 of row k of a row-major [K, N] operand with rows ld
// apart; zeros past K and N.
__device__ __forceinline__ float4 load_cols(const float* __restrict__ base,
                                            int k, int K, int n, int N,
                                            int ld, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k >= K || n >= N) return v;
  const float* p = base + (size_t)k * ld + n;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = __ldg(p);
  if (n + 1 < N) v.y = __ldg(p + 1);
  if (n + 2 < N) v.z = __ldg(p + 2);
  if (n + 3 < N) v.w = __ldg(p + 3);
  return v;
}

// Component i (0..3, known when compiled) of v.
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Split v into its hi and lo tf32 parts and store them at byte offset off
// of the hi and lo tiles.
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo,
                                            uint32_t off, float4 v) {
  float4 h, l;
  h.x = tf32_rna(v.x);
  h.y = tf32_rna(v.y);
  h.z = tf32_rna(v.z);
  h.w = tf32_rna(v.w);
  l.x = tf32_rna(v.x - h.x);
  l.y = tf32_rna(v.y - h.y);
  l.z = tf32_rna(v.z - h.z);
  l.w = tf32_rna(v.w - h.w);
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) = l;
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

// A block: one producer warpgroup and C consumer warpgroups; its tile of C
// is (64 C) x BN.
template <int C, int BN>
struct Tile {
  static constexpr int BM = 64 * C;
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kAChunks = BM * 8 / 128;  // per producer thread
  // B: (BN / 4 column chunks) x (8 k-groups of 4) cells, BN / 64 a
  // producer thread, four 16-byte loads each; JW warps along the columns
  static constexpr int kBCells = BN / 64;
  static constexpr int JW = BN / 32;
  static constexpr int kABytes = BM * 128;       // hi or lo of A
  static constexpr int kBBytes = BN * 128;
  static constexpr int kStageBytes = 2 * kABytes + 2 * kBBytes;
  // stages, 1,024 bytes of alignment slack, then the 2 kStages mbarriers
  static constexpr size_t kSmem = kStages * kStageBytes + 1024 +
                                  2 * kStages * sizeof(uint64_t);
};

template <int C, int BN>
__global__ void __launch_bounds__(128 * (C + 1), 1)
split_tf32_gemm_kernel(const float* __restrict__ A,
                       const float* __restrict__ B,
                       const float* __restrict__ bias, float* __restrict__ C_,
                       int M, int N, int K, int lda, int ldb, int vec_a,
                       int vec_b) {
  typedef Tile<C, BN> T;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // full[s]: the producer's 128 threads have split a slice into stage s;
  // empty[s]: the C consumer warpgroups are done reading it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages *
                                               T::kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * BN;
  const int slices = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer.  A: thread p loads the 16-byte chunk p % 8 of rows p / 8,
    // p / 8 + 16, ... of the slice's A rows.  B: lane bits (b, gg, jhi) =
    // (lane & 1, lane >> 1 & 3, lane >> 3) pick the column chunk
    // j = b + 2 jhi + 8 (warp % JW) and the k-group g = gg + 4 (...), so the
    // stored row 4 j + i meets swizzle position (gg ^ i) + 4 (b ^ g / 4):
    // one each for the 8 lanes of a store phase
    const int q = tid & 7;
    const int r0 = tid >> 3;
    const int lane = tid & 31, warp = tid >> 5;
    const int j = (lane & 1) + 2 * (lane >> 3) + 8 * (warp % T::JW);
    const int g0 = ((lane >> 1) & 3) + 4 * (warp / T::JW);
    float4 ra[T::kAChunks], rb[4 * T::kBCells];
    for (int t = 0; t < slices; ++t) {
      const int s = t % kStages;
      const int k = t * kBK + 4 * q;
#pragma unroll
      for (int i = 0; i < T::kAChunks; ++i)
        ra[i] = load_chunk(A, m0 + r0 + 16 * i, M, lda, k, K, vec_a);
#pragma unroll
      for (int c = 0; c < T::kBCells; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          rb[4 * c + r] = load_cols(B, t * kBK + 4 * (g0 + 4 * c) + r, K,
                                    n0 + 4 * j, N, ldb, vec_b);
      mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
      uint8_t* st = smem + s * T::kStageBytes;
#pragma unroll
      for (int i = 0; i < T::kAChunks; ++i)
        store_split(st, st + T::kABytes, swizzled(r0 + 16 * i, q), ra[i]);
      uint8_t* bt = st + 2 * T::kABytes;
#pragma unroll
      for (int c = 0; c < T::kBCells; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          store_split(bt, bt + T::kBBytes, swizzled(4 * j + i, g0 + 4 * c),
                      make_float4(comp(rb[4 * c], i), comp(rb[4 * c + 1], i),
                                  comp(rb[4 * c + 2], i),
                                  comp(rb[4 * c + 3], i)));
      // the stores reach the tensor cores (async proxy) before the arrival
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + s);
    }
    return;
  }

  // consumer warpgroup c: rows 64 c .. 64 c + 63 of the tile.  part: one
  // slice's sum on the tensor cores; acc: the running sum, in the same
  // layout, added to with round-to-nearest float32 adds
  const int c = wg - 1;
  float part[BN / 2], acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < slices; ++t) {
    const int s = t % kStages;
    mbar_wait(full + s, (t / kStages) & 1);
    const uint32_t st = smem_addr(smem + s * T::kStageBytes);
    const uint64_t a_hi = smem_desc(st + c * 64 * 128);
    const uint64_t a_lo = smem_desc(st + T::kABytes + c * 64 * 128);
    const uint64_t b_hi = smem_desc(st + 2 * T::kABytes);
    const uint64_t b_lo = smem_desc(st + 2 * T::kABytes + T::kBBytes);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_k8(part, a_hi + 2 * kk, b_hi + 2 * kk, kk > 0);
      wgmma_k8(part, a_lo + 2 * kk, b_hi + 2 * kk, 1);
      wgmma_k8(part, a_hi + 2 * kk, b_lo + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    if ((tid & 127) == 0) mbar_arrive(empty + s);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }

  // accumulator layout of m64nBN: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8); register 4 j + {0, 1} columns 8 j + 2 (lane % 4)
  // + {0, 1}, 4 j + {2, 3} the same columns 8 rows down
  const int lane = tid & 31;
  const int row = m0 + c * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
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

template <int C, int BN>
cudaError_t launch(const float* A, const float* B, const float* bias,
                   float* out, int M, int N, int K, int lda, int ldb,
                   cudaStream_t stream) {
  typedef Tile<C, BN> T;
  const void* kernel = (const void*)split_tf32_gemm_kernel<C, BN>;
  cudaError_t err = set_smem(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  const int vec_a = K % 4 == 0 && lda % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int vec_b = N % 4 == 0 && ldb % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(B) % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM);
  split_tf32_gemm_kernel<C, BN><<<grid, T::kThreads, T::kSmem, stream>>>(
      A, B, bias, out, M, N, K, lda, ldb, vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// C[M, N] = A[M, K] @ B[K, N] (+ bias[N] unless null), float32, on the
// given stream; C rows N apart; 128 x 128 block tiles.  Returns a
// cudaError_t.
extern "C" int subgc_split_gemm_f32(const float* A, const float* B,
                                    const float* bias, float* C, int M,
                                    int N, int K, int lda, int ldb,
                                    void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K < 0 || lda < K || ldb < N) return (int)cudaErrorInvalidValue;
  return (int)launch<2, 128>(A, B, bias, C, M, N, K, lda, ldb,
                             static_cast<cudaStream_t>(stream));
}
