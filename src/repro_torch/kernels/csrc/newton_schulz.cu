// Newton-Schulz kernels for Hopper (sm_90a), f32 in, f32 accumulate, f32 out.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/newton_schulz.py:
//
//   * ns_fused_matmul_f32 -> _fused_matmul_kernel / fused_matmul (kernel 2):
//       out[b] = alpha * C[b] + beta * (A[b] @ op(B[b])),  op = id or transpose.
//     A batched, tiled GEMM with the epilogue fused. Ragged edges are
//     masked, so no caller has to pad.
//
//   * ns_syrk_upper_f32 -> the gram phase of _ns_fused_kernel (kernel 1):
//       G[b] = X[b] @ X[b]^T, computing only the tiles (i, j) with i <= j
//       and writing each together with its mirror.
//     One NS iteration X' = aX + (bA + cA^2)X, A = XX^T, is then three
//     launches (repro_torch/kernels/newton_schulz.py::ns_iteration):
//       syrk_upper(X) -> G;  fused_matmul(G, G, C=G, alpha=b, beta=c) -> P;
//       fused_matmul(P, X, C=X, alpha=a, beta=1) -> X'.
//
// What bounds it on this card, and what the design does about it:
//   The TPU kernel keeps the [m, m] f32 gram and poly in VMEM for the whole
//   iteration. A Hopper block has at most 227 KB of shared memory, and
//   nanogpt's 768 x 768 f32 gram alone is 2.36 MB, so gram and poly live in
//   a [B, m, m] f32 workspace in device memory (L2 holds much of it) and the
//   iteration takes three launches. The work is operation-bound: per nanogpt
//   step about 1.1 TFLOP of f32 needed (the gram and A^2 are symmetric; the
//   kernels execute 1.4 TFLOP) against some 0.7 GB of operand traffic, so
//   the bound is the f32 rate of the CUDA cores (67 TFLOP/s on an H100 SXM
//   outside the tensor cores). The kernels keep f32 end to end to match the
//   reference's f32 LMO, so they run on FFMA, not wgmma: each block computes
//   a 128 x 128 output tile from 8-deep shared-memory slices, each of its 256
//   threads an 8 x 8 register tile, so every shared-memory load feeds eight
//   FMAs. The gram kernel does T(T+1)/2 of the T^2 tile products, as the TPU
//   kernel does. TF32 or bf16 wgmma, TMA and a persistent schedule are left
//   for later work.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;   // output tile rows
constexpr int BN = 128;   // output tile columns
constexpr int BK = 8;     // depth of one shared-memory slice
constexpr int TM = 8;     // rows a thread owns
constexpr int TN = 8;     // columns a thread owns
constexpr int NTHREADS = 256;
constexpr int PAD = 4;    // breaks the 2-way bank conflict of the transposed stores

static_assert((BM / TM) * (BN / TN) == NTHREADS, "one thread per 8x8 sub-tile");

// acc[i][j] += sum_k A[row0 + ty + 16 i, k] * op(B)[k, col0 + tx + 16 j].
// A is [M, K] row-major. op(B) is [K, N]: B is stored [K, N] (TRANS_B false)
// or [N, K] (TRANS_B true). Out-of-range elements load as zero.
template <bool TRANS_B>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          int M, int N, int K,
                                          int row0, int col0,
                                          float (&acc)[TM][TN],
                                          float (*As)[BM + PAD],
                                          float (*Bs)[BN + PAD]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // A slice [BM, BK]: thread loads 4 consecutive k of one row
  const int a_r = tid >> 1;
  const int a_c = (tid & 1) * 4;
  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int gr = row0 + a_r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gc = k0 + a_c + q;
        As[a_c + q][a_r] =
            (gr < M && gc < K) ? A[(size_t)gr * K + gc] : 0.0f;
      }
    }
    if (TRANS_B) {
      // B stored [N, K]: same pattern as A, stored transposed
      const int gn = col0 + a_r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gk = k0 + a_c + q;
        Bs[a_c + q][a_r] =
            (gn < N && gk < K) ? B[(size_t)gn * K + gk] : 0.0f;
      }
    } else {
      // B stored [K, N]: a warp loads 128 consecutive columns of one row
      const int r = tid >> 5;
      const int c = (tid & 31) * 4;
      const int gk = k0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gn = col0 + c + q;
        Bs[r][c + q] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <bool TRANS_B>
__global__ void __launch_bounds__(NTHREADS)
fused_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ C, float* __restrict__ O,
                    int M, int N, int K, long long sA, long long sB,
                    long long sC, long long sO, float alpha, float beta) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const long long b = blockIdx.z;
  A += b * sA;
  B += b * sB;
  O += b * sO;
  if (C != nullptr) C += b * sC;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  gemm_tile<TRANS_B>(A, B, M, N, K, row0, col0, acc, As, Bs);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float v = beta * acc[i][j];
      if (C != nullptr) v += alpha * C[(size_t)r * N + c];
      O[(size_t)r * N + c] = v;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
syrk_upper_kernel(const float* __restrict__ X, float* __restrict__ G, int M,
                  int K, long long sX, long long sG, int T) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
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
  G += b * sG;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  gemm_tile<true>(X, X, M, M, K, ti * BM, tj * BN, acc, As, Bs);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ti * BM + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tj * BN + tx + 16 * j;
      if (c >= M) continue;
      G[(size_t)r * M + c] = acc[i][j];
      // the products commute bit for bit, so the mirror equals what the
      // lower tile would have computed
      if (ti != tj) G[(size_t)c * M + r] = acc[i][j];
    }
  }
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
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_b) {
    fused_matmul_kernel<true><<<grid, NTHREADS, 0, s>>>(
        A, B, C, out, M, N, K, sA, sB, sC, sO, alpha, beta);
  } else {
    fused_matmul_kernel<false><<<grid, NTHREADS, 0, s>>>(
        A, B, C, out, M, N, K, sA, sB, sC, sO, alpha, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

// G[b] = X[b] @ X[b]^T for b < batch; X [M, K], G [M, M], row-major f32,
// batch strides sX, sG in elements.
int ns_syrk_upper_f32(const float* X, float* G, int batch, int M, int K,
                      long long sX, long long sG, void* stream) {
  const int T = (M + BM - 1) / BM;
  const dim3 grid(T * (T + 1) / 2, batch);
  syrk_upper_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      X, G, M, K, sX, sG, T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
