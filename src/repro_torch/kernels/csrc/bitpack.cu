// Wire bit-packing kernels for Hopper (sm_90a): bytes and integers only.
//
// Replace the Pallas TPU kernels of src/repro/kernels/bitpack.py:
//
//   * bp_narrow_encode -> narrow_encode / _narrow_encode_kernel:
//       int32 [R, k] in [0, 2^(8w)) -> uint8 [R, w*k]; within each row,
//       plane p holds byte p of every element (plane-major, little-endian).
//   * bp_narrow_decode -> narrow_decode / _narrow_decode_kernel: the inverse,
//       a shift-accumulate over the w planes.
//   * bp_pack_bits -> pack_bits / _pack_bits_kernel:
//       uint8 [8n] -> uint8 [n], out[e] = sum_l in[8e + l] << l (mod 256):
//       8 {0,1} bytes -> one byte, LSB first.
//   * bp_unpack_bits -> unpack_bits / _unpack_bits_kernel:
//       uint8 [n] -> uint8 [8n], out[8e + l] = (in[e] >> l) & 1.
//
// Rows are independent messages (one per worker and stack slice), so the
// row-batched narrow kernels take a whole parameter leaf in one launch.
// pack_bits and unpack_bits need no row notion: a row of 8k bits packs to
// a row of k bytes, so flat indices line up across rows.
//
// What bounds them on this card, and what the design does about it:
//   Each does at most ~4 integer operations per byte it moves (address
//   arithmetic aside), below the ~5 INT32 operations an H100 SXM issues in
//   the time it moves one byte of HBM (16.7 T ops/s against 3.35 TB/s), so
//   all four are bound by bytes. The TPU kernels express the
//   8:1 bit folds as matmuls against selector matrices because the TPU's
//   vector unit has no cheap lane shuffles; here every thread owns output
//   elements and uses plain shifts. Threads of a warp touch consecutive
//   addresses of each plane or bitmap, so loads and stores coalesce.
//   The 8:1 pair moves its 8-byte side as one 8-byte word per thread:
//   pack_bits loads its 8 input bytes at once (when the input is 8-byte
//   aligned), and unpack_bits stores its 8 output bytes at once (its
//   output is always a fresh, aligned allocation), because a store of one
//   byte per thread ran at a tenth of the memory rate on an H100. The
//   narrow planes and Natural's planes are still stored a byte per
//   thread; widening those is later work.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;   // grid-stride beyond this

inline int blocks_for(long long n) {
  const long long b = (n + NTHREADS - 1) / NTHREADS;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

__global__ void narrow_encode_kernel(const int32_t* __restrict__ idx,
                                     uint8_t* __restrict__ out,
                                     long long k, long long n, int width) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / k;
    const long long i = e - r * k;
    const uint32_t v = static_cast<uint32_t>(idx[e]);
    uint8_t* row = out + r * width * k + i;
    for (int p = 0; p < width; ++p) row[p * k] = (v >> (8 * p)) & 0xFF;
  }
}

__global__ void narrow_decode_kernel(const uint8_t* __restrict__ in,
                                     int32_t* __restrict__ out,
                                     long long k, long long n, int width) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / k;
    const long long i = e - r * k;
    const uint8_t* row = in + r * width * k + i;
    uint32_t acc = 0;
    for (int p = 0; p < width; ++p)
      acc |= static_cast<uint32_t>(row[p * k]) << (8 * p);
    out[e] = static_cast<int32_t>(acc);
  }
}

template <bool ALIGNED>
__global__ void pack_bits_kernel(const uint8_t* __restrict__ in,
                                 uint8_t* __restrict__ out, long long n_out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n_out; e += (long long)gridDim.x * blockDim.x) {
    uint32_t acc = 0;
    if (ALIGNED) {
      // little-endian: byte l of the word is in[8e + l]
      const uint64_t w = reinterpret_cast<const uint64_t*>(in)[e];
#pragma unroll
      for (int l = 0; l < 8; ++l)
        acc += static_cast<uint32_t>((w >> (8 * l)) & 0xFF) << l;
    } else {
#pragma unroll
      for (int l = 0; l < 8; ++l)
        acc += static_cast<uint32_t>(in[8 * e + l]) << l;
    }
    out[e] = static_cast<uint8_t>(acc & 0xFF);
  }
}

// out must be 8-byte aligned: thread e writes out[8e .. 8e + 7] as one word
__global__ void unpack_bits_kernel(const uint8_t* __restrict__ in,
                                   uint8_t* __restrict__ out,
                                   long long n_in) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n_in; e += (long long)gridDim.x * blockDim.x) {
    const uint32_t b = in[e];
    uint64_t w = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l)
      w |= static_cast<uint64_t>((b >> l) & 1) << (8 * l);   // little-endian
    reinterpret_cast<uint64_t*>(out)[e] = w;
  }
}

}  // namespace

extern "C" {

// idx int32 [rows, k] -> out uint8 [rows, width * k]; width in {2, 3, 4}.
int bp_narrow_encode(const int32_t* idx, uint8_t* out, long long rows,
                     long long k, int width, void* stream) {
  const long long n = rows * k;
  narrow_encode_kernel<<<blocks_for(n), NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(idx, out, k, n,
                                                              width);
  return static_cast<int>(cudaGetLastError());
}

// in uint8 [rows, width * k] -> out int32 [rows, k].
int bp_narrow_decode(const uint8_t* in, int32_t* out, long long rows,
                     long long k, int width, void* stream) {
  const long long n = rows * k;
  narrow_decode_kernel<<<blocks_for(n), NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(in, out, k, n,
                                                              width);
  return static_cast<int>(cudaGetLastError());
}

// in uint8 [8 * n_out] -> out uint8 [n_out].
int bp_pack_bits(const uint8_t* in, uint8_t* out, long long n_out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(in) % 8 == 0)
    pack_bits_kernel<true><<<blocks_for(n_out), NTHREADS, 0, s>>>(in, out,
                                                                  n_out);
  else
    pack_bits_kernel<false><<<blocks_for(n_out), NTHREADS, 0, s>>>(in, out,
                                                                   n_out);
  return static_cast<int>(cudaGetLastError());
}

// in uint8 [n_in] -> out uint8 [8 * n_in] of {0, 1}; out 8-byte aligned
// (cudaErrorMisalignedAddress otherwise, without a launch).
int bp_unpack_bits(const uint8_t* in, uint8_t* out, long long n_in,
                   void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  unpack_bits_kernel<<<blocks_for(n_in), NTHREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(in, out, n_in);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
