// Newton-Schulz kernels for Hopper (sm_90a): f32 in, f32 out, f32-accurate
// products on the tensor cores (3xTF32 on wgmma).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/newton_schulz.py:
//
//   * ns_fused_matmul_f32 -> _fused_matmul_kernel / fused_matmul (kernel 2):
//       out[b] = alpha * C[b] + beta * (A[b] @ op(B[b])),  op = id or transpose.
//     A batched GEMM with the epilogue fused; ragged M, N, K are masked, so
//     no caller has to pad.
//
//   * ns_syrk_upper_f32 -> the gram and poly phases of _ns_fused_kernel
//     (kernel 1):
//       out[b] = beta * X[b] @ X[b]^T + alpha * C[b],
//     computing only the upper tiles (i <= j) and writing each element of
//     the upper triangle together with its mirror, so out is exactly
//     symmetric; C is read on its upper triangle only.
//     One NS iteration X' = aX + (bA + cA^2)X, A = XX^T, is three launches
//     (repro_torch/kernels/newton_schulz.py::ns_iteration):
//       syrk_upper(X) -> G;  syrk_upper(G, C=G, alpha=b, beta=c) -> P;
//       fused_matmul(P, X, C=X, alpha=a, beta=1) -> X'.
//     The poly uses G @ G^T = G @ G, which holds because G is exactly
//     symmetric: it does T(T+1)/2 of the T^2 tile products, as the gram.
//
// What bounds it on this card, and what the design does about it:
//   The work is operation-bound: per nanogpt step 1.1 TFLOP of f32 against
//   some 0.7 GB of operand traffic. The TPU kernel keeps the [m, m] gram
//   and poly in VMEM; a Hopper block has 227 KB of shared memory and
//   nanogpt's 768 x 768 f32 gram is 2.36 MB, so gram and poly live in a
//   [B, m, m] f32 workspace (L2 holds much of it) and an iteration is three
//   launches. The port matches the reference's f32 LMO to 1e-5 of scale,
//   which rules out one-pass TF32 (a 10-bit mantissa: 4e-5 to 3e-4 of scale
//   at K = 3072, tests/test_torch_ns_precision.py). The first version ran
//   on the CUDA cores (67 TFLOP/s of FFMA) and lost to cuBLAS's f32 SGEMM.
//   This one runs on the tensor cores at f32 accuracy by the 3xTF32 split:
//     - every f32 operand v becomes hi = tf32_rn(v) and lo = tf32_rn(v - hi)
//       (cvt.rna: the tensor core ignores the low 13 bits, so an operand
//       that is not rounded first loses them silently);
//     - each product is lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of it,
//       dropped), the small terms issued first;
//     - the tensor core's sums are not IEEE round-to-nearest (they
//       truncate), and a truncated sum carried through all of K = 3072
//       drifts toward zero by a few 1e-5 of scale on a gram's diagonal. So
//       each 64-deep span of K sums into a fresh register tile, which is
//       then added to the running f32 sum by an ordinary FADD
//       ("promotion"; tests/test_torch_ns_precision.py emulates both).
//   The bound at f32 accuracy is three TF32 products per f32 product at
//   495 TFLOP/s dense TF32, 165 TFLOP/s, 2.5x the FFMA ceiling.
//
//   The MMA is wgmma.mma_async m64n128k8 TF32 with both operands in shared
//   memory. TF32 wgmma reads only K-major tiles in its own swizzled layout,
//   and the operands must already be split, so each K slice passes through
//   shared memory twice:
//     - a 3-stage ring of 32-deep f32 slices of A and B, filled 3 slices
//       ahead by cp.async 16-byte copies (4-byte copies where a row stride
//       is not a multiple of 4 floats: the same kernel with a narrower
//       copy; out-of-range elements are zero-filled);
//     - a split pass, by all 256 threads, turns each landed slice into hi
//       and lo TF32 tiles of A and B, K-major with the 128-byte swizzle
//       (16-byte chunk q of row r at chunk q ^ (r % 8)), double-buffered so
//       that splitting slice k+1 overlaps the wgmmas of slice k. The update
//       X' = aX + PX reads X stored [K = m, N = n] (N-major): the split pass
//       transposes it. No hi/lo copy ever exists in device memory.
//   Each block computes a 128 x 128 output tile with two warpgroups of
//   64 x 128 (12 wgmmas per slice each); 225 KB of shared memory, one
//   block per SM. By count, shared memory is what bounds it now: per slice
//   the wgmmas read 144 KB (each m64n128k8 reads its 2 KB of A and 4 KB of
//   B again) and the copies and the split move 128 KB more, some 2,100
//   clocks at 128 B/clock against 1,540 clocks of TF32 tensor work.
//   Register-sourced A (wgmma's RS form), a persistent schedule that
//   overlaps one tile's epilogue with the next tile's loads, and TMA are
//   left for a later redesign.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output tile rows (2 warpgroups x 64)
constexpr int BN = 128;        // output tile columns (one wgmma's N)
constexpr int BK = 32;         // depth of one slice: 4 wgmma k-steps of 8
constexpr int STAGES = 3;      // f32 ring of slices
constexpr int PROMOTE = 2;     // slices summed apart before the f32 add
constexpr int NTHREADS = 256;

// f32 ring slot: A [BM][BK] then B, [BN][BK] (K-major) or [BK][BN].
constexpr int SLOT = (BM + BN) * BK;
// split buffer: A hi, A lo [BM][BK], B hi, B lo [BN][BK], TF32, swizzled
constexpr int SPLIT = 2 * (BM + BN) * BK;
constexpr int SMEM_BYTES = (2 * SPLIT + STAGES * SLOT) * 4 + 1024;

static_assert(BM == BN, "the split and copy loops share their trip counts");
static_assert(BK * 4 == 128, "one tile row is one 128-byte swizzle row");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on an H100");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (VEC) or 4 bytes from global to shared memory; zero-fill when !ok.
template <bool VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 128) x columns [k0, k0 + BK) of a row-major [rows, K]
// matrix into S[128][BK].
template <bool VEC>
__device__ __forceinline__ void load_kmajor(float* S,
                                            const float* __restrict__ P,
                                            int rows, int K, int r0, int k0) {
  constexpr int W = VEC ? 4 : 1;           // floats per copy
  constexpr int PER_ROW = BK / W;
#pragma unroll
  for (int i = 0; i < BM * PER_ROW / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c / PER_ROW;
    const int q = (c % PER_ROW) * W;
    const int gr = r0 + r;
    const int gk = k0 + q;
    const bool ok = gr < rows && gk < K;   // K % W == 0 when VEC
    cp_async<VEC>(S + r * BK + q, ok ? P + (size_t)gr * K + gk : P, ok);
  }
}

// Rows [k0, k0 + BK) x columns [n0, n0 + 128) of a row-major [K, N]
// matrix into S[BK][128].
template <bool VEC>
__device__ __forceinline__ void load_nmajor(float* S,
                                            const float* __restrict__ P,
                                            int K, int N, int k0, int n0) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int PER_ROW = BN / W;
#pragma unroll
  for (int i = 0; i < BK * PER_ROW / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int k = c / PER_ROW;
    const int q = (c % PER_ROW) * W;
    const int gk = k0 + k;
    const int gn = n0 + q;
    const bool ok = gk < K && gn < N;      // N % W == 0 when VEC
    cp_async<VEC>(S + k * BN + q, ok ? P + (size_t)gk * N + gn : P, ok);
  }
}

__device__ __forceinline__ uint32_t tf32_rn(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// One f32 tile of the ring (S [128][BK] when KMAJOR, else [BK][128]) ->
// hi and lo TF32 tiles [128][BK], K-major, 128-byte swizzle: the 16-byte
// chunk q of row r sits at chunk q ^ (r % 8), as wgmma reads it.
// v = hi + lo + O(2^-22 v), both parts rounded to nearest.
template <bool KMAJOR>
__device__ __forceinline__ void split_tile(const float* S, float* hi,
                                           float* lo) {
#pragma unroll
  for (int i = 0; i < BN * BK / 4 / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    int r, q;
    float v[4];
    if (KMAJOR) {     // a quarter-warp reads one row's 8 chunks
      r = c / (BK / 4);
      q = c % (BK / 4);
      const float4 f = *reinterpret_cast<const float4*>(S + r * BK + 4 * q);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {          // transpose: a warp reads 32 columns of one row
      r = c % BN;
      q = c / BN;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = S[(4 * q + j) * BN + r];
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = tf32_rn(v[j]);
      l[j] = tf32_rn(v[j] - __uint_as_float(h[j]));   // the difference is exact
    }
    const int dst = r * BK + ((q ^ (r % 8)) * 4);
    *reinterpret_cast<uint4*>(hi + dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + dst) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile
// whose 8-row groups are 1024 bytes apart; p is 1024-byte aligned, plus
// 32 bytes per k-step of 8.
__device__ __forceinline__ uint64_t desc_of(const float* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4)            // start address
         | (uint64_t{1} << 16)              // leading byte offset (unused)
         | (uint64_t{1024 >> 4} << 32)      // stride byte offset
         | (uint64_t{1} << 62);             // 128-byte swizzle
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

// d (+)= A @ B^T for the warpgroup's 64 x 128 tile and one k-step of 8:
// A [64][8] and B [128][8] TF32 from shared memory. scale_d = 0 starts d
// from zero. Accumulator layout: thread (warp w of the warpgroup, lane l)
// holds d[4j + e] at row 16w + l/4 + 8(e/2), column 8j + 2(l%4) + e%2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// acc = the block's 128 x 128 tile (rows row0.., columns col0..) of
// A @ op(B): A [M, K] row-major; op(B) [K, N] with B stored [N, K]
// (KMAJOR_B) or [K, N]. VEC: 16-byte copies (K, and N when B is N-major,
// multiples of 4; 16-byte aligned bases). Each thread ends with its
// warpgroup's accumulator layout (see wgmma_tf32).
template <bool VEC, bool KMAJOR_B>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* __restrict__ B, int M,
                                          int N, int K, int row0, int col0,
                                          float* smem_raw, float (&acc)[64]) {
  // split buffers first, 1024-byte aligned for the swizzle; then the ring
  const uint32_t base = smem_addr(smem_raw);
  float* split = smem_raw + ((1024 - (base & 1023)) & 1023) / 4;
  float* ring = split + 2 * SPLIT;
  const int wg = threadIdx.x / 128;
  const int kt_n = (K + BK - 1) / BK;

  auto load = [&](int kt) {
    float* S = ring + (kt % STAGES) * SLOT;
    load_kmajor<VEC>(S, A, M, K, row0, kt * BK);
    if (KMAJOR_B) {
      load_kmajor<VEC>(S + BM * BK, B, N, K, col0, kt * BK);
    } else {
      load_nmajor<VEC>(S + BM * BK, B, K, N, kt * BK, col0);
    }
  };
  auto split_slice = [&](int kt) {
    const float* S = ring + (kt % STAGES) * SLOT;
    float* s = split + (kt % 2) * SPLIT;
    split_tile<true>(S, s, s + BM * BK);
    split_tile<KMAJOR_B>(S + BM * BK, s + 2 * BM * BK, s + 3 * BM * BK);
    // the next readers are wgmmas (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < kt_n) load(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  if (kt_n > 0) split_slice(0);
  __syncthreads();
  float part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) part[e] = 0.0f;
  for (int kt = 0; kt < kt_n; ++kt) {
    // ring slot kt was split at kt - 1 (or before the loop): refill it
    if (kt + STAGES < kt_n) load(kt + STAGES);
    cp_async_commit();
    const float* s = split + (kt % 2) * SPLIT;
    const float* a_hi = s + wg * 64 * BK;
    const float* a_lo = a_hi + BM * BK;
    const float* b_hi = s + 2 * BM * BK;
    const float* b_lo = b_hi + BN * BK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // small terms first; the first wgmma of a promotion span starts part
      wgmma_tf32(part, desc_of(a_lo + kk), desc_of(b_hi + kk),
                 kk > 0 || kt % PROMOTE != 0);
      wgmma_tf32(part, desc_of(a_hi + kk), desc_of(b_lo + kk), 1);
      wgmma_tf32(part, desc_of(a_hi + kk), desc_of(b_hi + kk), 1);
    }
    wgmma_commit();
    if (kt + 1 < kt_n) {
      wgmma_wait<1>();                 // wgmma(kt - 1) has read buffer kt+1
      cp_async_wait<STAGES - 1>();     // ring slot kt + 1 has landed
      __syncthreads();                 // ... for both warpgroups
      split_slice(kt + 1);
    }
    if (kt % PROMOTE == PROMOTE - 1 || kt + 1 == kt_n) {
      // promotion: the span's sum enters the running sum rounded to nearest
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[e];
    }
    __syncthreads();                   // buffer kt + 1 is complete
  }
  cp_async_wait<0>();
}

// Tile row and column of the thread's accumulator element e.
__device__ __forceinline__ int row_of(int e) {
  const int warp = threadIdx.x / 32;
  return (warp / 4) * 64 + (warp % 4) * 16 + (threadIdx.x % 32) / 4 +
         (e % 4 >= 2 ? 8 : 0);
}

__device__ __forceinline__ int col_of(int e) {
  return (e / 4) * 8 + (threadIdx.x % 4) * 2 + (e & 1);
}

template <bool VEC, bool TRANS_B>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ C, float* __restrict__ O,
                    int M, int N, int K, long long sA, long long sB,
                    long long sC, long long sO, float alpha, float beta) {
  extern __shared__ __align__(16) float smem[];
  const long long b = blockIdx.z;
  A += b * sA;
  B += b * sB;
  O += b * sO;
  if (C != nullptr) C += b * sC;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  gemm_tile<VEC, TRANS_B>(A, B, M, N, K, row0, col0, smem, acc);
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = row0 + row_of(e);
    const int c = col0 + col_of(e);
    if (r >= M || c >= N) continue;
    float v = beta * acc[e];
    if (C != nullptr) v += alpha * C[(size_t)r * N + c];
    O[(size_t)r * N + c] = v;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
syrk_upper_kernel(const float* __restrict__ X, const float* __restrict__ C,
                  float* __restrict__ O, int M, int K, long long sX,
                  long long sC, long long sO, int T, float alpha,
                  float beta) {
  extern __shared__ __align__(16) float smem[];
  // blockIdx.x enumerates the upper-triangular tile pairs (ti <= tj)
  int p = blockIdx.x;
  int ti = 0;
  while (p >= T - ti) {
    p -= T - ti;
    ++ti;
  }
  const int tj = ti + p;
  const long long b = blockIdx.y;
  X += b * sX;
  O += b * sO;
  if (C != nullptr) C += b * sC;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  gemm_tile<VEC, true>(X, X, M, M, K, ti * BM, tj * BN, smem, acc);
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = ti * BM + row_of(e);
    const int c = tj * BN + col_of(e);
    // the upper triangle only (below the diagonal of a diagonal tile,
    // the element's mirror writes it)
    if (r >= M || c >= M || r > c) continue;
    float v = beta * acc[e];
    if (C != nullptr) v += alpha * C[(size_t)r * M + c];
    O[(size_t)r * M + c] = v;
    if (r != c) O[(size_t)c * M + r] = v;
  }
}

// Opt a kernel into its dynamic shared memory (above the 48 KB default),
// once per kernel and device: `done` is the kernel's own mask of devices.
cudaError_t allow_smem(const void* kernel, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (bit != 0 && (done & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <bool VEC, bool TRANS_B>
int launch_fused_matmul(const float* A, const float* B, const float* C,
                        float* out, int batch, int M, int N, int K,
                        long long sA, long long sB, long long sC,
                        long long sO, float alpha, float beta,
                        cudaStream_t s) {
  static uint64_t done = 0;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(fused_matmul_kernel<VEC, TRANS_B>), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  fused_matmul_kernel<VEC, TRANS_B><<<grid, NTHREADS, SMEM_BYTES, s>>>(
      A, B, C, out, M, N, K, sA, sB, sC, sO, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_syrk_upper(const float* X, const float* C, float* out, int batch,
                      int M, int K, long long sX, long long sC, long long sO,
                      float alpha, float beta, cudaStream_t s) {
  static uint64_t done = 0;
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(syrk_upper_kernel<VEC>), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = (M + BM - 1) / BM;
  const dim3 grid(T * (T + 1) / 2, batch);
  syrk_upper_kernel<VEC><<<grid, NTHREADS, SMEM_BYTES, s>>>(
      X, C, out, M, K, sX, sC, sO, T, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// out[b] = alpha * C[b] + beta * (A[b] @ op(B[b])) for b < batch.
// A [M, K], op(B) [K, N] (B stored [K, N], or [N, K] when trans_b), C and
// out [M, N], all row-major f32; s* are batch strides in elements (0
// broadcasts one matrix over the batch). C may be null.
int ns_fused_matmul_f32(const float* A, const float* B, const float* C,
                        float* out, int batch, int M, int N, int K,
                        long long sA, long long sB, long long sC,
                        long long sO, int trans_b, float alpha, float beta,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(A) && aligned16(B) && K % 4 == 0 &&
                   (trans_b || N % 4 == 0) && sA % 4 == 0 && sB % 4 == 0;
  if (trans_b) {
    return vec ? launch_fused_matmul<true, true>(A, B, C, out, batch, M, N, K,
                                                 sA, sB, sC, sO, alpha, beta, s)
               : launch_fused_matmul<false, true>(A, B, C, out, batch, M, N,
                                                  K, sA, sB, sC, sO, alpha,
                                                  beta, s);
  }
  return vec ? launch_fused_matmul<true, false>(A, B, C, out, batch, M, N, K,
                                                sA, sB, sC, sO, alpha, beta, s)
             : launch_fused_matmul<false, false>(A, B, C, out, batch, M, N, K,
                                                 sA, sB, sC, sO, alpha, beta,
                                                 s);
}

// out[b] = beta * X[b] @ X[b]^T + alpha * C[b] for b < batch, computed on
// the upper triangle (C read there only) and mirrored. X [M, K], C and
// out [M, M], row-major f32; batch strides sX, sC, sO in elements. C may
// be null.
int ns_syrk_upper_f32(const float* X, const float* C, float* out, int batch,
                      int M, int K, long long sX, long long sC, long long sO,
                      float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(X) && K % 4 == 0 && sX % 4 == 0;
  return vec ? launch_syrk_upper<true>(X, C, out, batch, M, K, sX, sC, sO,
                                       alpha, beta, s)
             : launch_syrk_upper<false>(X, C, out, batch, M, K, sX, sC, sO,
                                        alpha, beta, s);
}

}  // extern "C"
