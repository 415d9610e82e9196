// Natural-compression encode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/natural_pack.py
// (natural_encode / _natural_encode_kernel): every value, cast to bf16 with
// round-to-nearest-even, becomes
//   code = 0 for +-0, else min(exponent + top mantissa bit, 254)
//          (the exponent of the nearest power of two; inf and NaN -> 254)
//   sign = the sign bit
// as two uint8 planes of the input's shape. The 8:1 packing of the sign
// plane is pack_bits (bitpack.cu), as on the TPU.
//
// What bounds it on this card, and what the design does about it:
//   A handful of integer operations per element against 4 bytes moved per
//   bf16 element (2 read, 2 written), so it is bound by bytes (3.35 TB/s on
//   an H100 SXM). One thread per element; threads of a warp read and write
//   consecutive addresses, so every access coalesces. f32 input is cast with
//   __float2bfloat16_rn, the conversion PyTorch's own CUDA cast uses, so the
//   codes are PyTorch's x.to(torch.bfloat16) bit for bit.
//
// The entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;   // grid-stride beyond this

template <bool BF16>
__global__ void natural_encode_kernel(const void* __restrict__ x,
                                      uint8_t* __restrict__ code,
                                      uint8_t* __restrict__ sign,
                                      long long n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    uint32_t bits;
    if (BF16)
      bits = static_cast<const uint16_t*>(x)[e];
    else
      bits = __bfloat16_as_ushort(
          __float2bfloat16_rn(static_cast<const float*>(x)[e]));
    const uint32_t exp = (bits >> 7) & 0xFF;
    const uint32_t rounded = min(exp + ((bits >> 6) & 1), 254u);
    code[e] = (bits & 0x7FFF) == 0 ? 0 : static_cast<uint8_t>(rounded);
    sign[e] = static_cast<uint8_t>(bits >> 15);
  }
}

}  // namespace

extern "C" {

// x [n] f32 (is_bf16 == 0) or bf16 (is_bf16 == 1) -> code, sign uint8 [n].
int nat_encode(const void* x, int is_bf16, uint8_t* code, uint8_t* sign,
               long long n, void* stream) {
  const long long b = (n + NTHREADS - 1) / NTHREADS;
  const int blocks = static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    natural_encode_kernel<true><<<blocks, NTHREADS, 0, s>>>(x, code, sign, n);
  else
    natural_encode_kernel<false><<<blocks, NTHREADS, 0, s>>>(x, code, sign,
                                                             n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
