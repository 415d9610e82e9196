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
//   byte per thread ran at a tenth of the memory rate on an H100.
//   narrow_encode still stores its planes a byte per thread; widening it
//   is later work.
//
// narrow_decode reads its rows in place, at any row stride and any byte
// alignment (the codec hands it column slices of a wire stage buffer), and
// is built for bytes in flight:
//   * the row and the chunk of the row come from a 2-D grid, so no element
//     pays a 64-bit division; offsets within a row are 32-bit;
//   * elements go in groups of 4 whose output starts 16-byte aligned (a
//     row's first and last few elements are decoded one at a time), so
//     each group is one int4 store;
//   * a chunk's bytes of plane p start at an arbitrary byte alignment
//     (row lengths and strides are odd byte counts: k = 58,983 on
//     nanogpt), so the block stages each plane's span of its chunk in
//     shared memory with aligned 16-byte loads (all of them issued before
//     the first store to shared memory), and each thread then reads a
//     group's 4 bytes of a plane as two aligned shared words funnel-shifted
//     together. On an H100 this ran 0.7% faster over a step's decodes
//     (1.4% on the stage buffer's slices) than the same groups loaded as
//     aligned 4-byte words straight from device memory;
//   * each thread takes DEC_CHUNK / NTHREADS = 16 elements of its chunk
//     and has width 16-byte loads in flight: ~96 KB an SM at 8 resident
//     blocks, where ~15 KB reach the memory rate.

// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;   // grid-stride beyond this
constexpr int DEC_CHUNK = 4096;   // narrow_decode: elements a block

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

// Row r of in starts at in + r * stride and holds width planes of k bytes;
// row r of out starts at out + r * k, and out is 16-byte aligned. Block
// (x, y) decodes chunk x (DEC_CHUNK elements) of rows y, y + gridDim.y, ...
template <int W>
__global__ void __launch_bounds__(NTHREADS)
    narrow_decode_kernel(const uint8_t* __restrict__ in, long long stride,
                         int32_t* __restrict__ out, long long rows, int k) {
  // each plane's span of the chunk: DEC_CHUNK bytes from any alignment fit
  // in DEC_CHUNK / 16 + 1 aligned 16-byte vectors
  constexpr int NVEC = DEC_CHUNK / 16 + 1;
  __shared__ uint4 stage[W][NVEC];
  const int t = threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint8_t* row = in + r * stride;
    int32_t* orow = out + r * k;
    // groups of 4 from element `head` on, each starting 16-byte aligned in
    // out; elements [0, head) and [body_end, k) one at a time
    const int head = min(static_cast<int>((4 - (r * k) % 4) % 4), k);
    const int body_end = head + 4 * ((k - head) / 4);
    if (blockIdx.x == 0 && t < head + (k - body_end)) {
      const int i = t < head ? t : body_end + (t - head);
      uint32_t acc = 0;
#pragma unroll
      for (int p = 0; p < W; ++p)
        acc |= static_cast<uint32_t>(row[p * k + i]) << (8 * p);
      orow[i] = static_cast<int32_t>(acc);
    }
    const int i0 = head + blockIdx.x * DEC_CHUNK;   // the same for the block
    if (i0 >= body_end) continue;
    const int len = min(DEC_CHUNK, body_end - i0);

    // stage plane p's bytes [i0, i0 + len) from the aligned vector that
    // holds the first of them; off[p] is that byte's place in the vector.
    // The last vector may reach past the row, never past the aligned
    // vector that holds the row's last byte. All loads are issued before
    // any store to shared memory.
    const uint4* src[W];
    int off[W], nvec[W];
#pragma unroll
    for (int p = 0; p < W; ++p) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(row + p * k + i0);
      src[p] = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
      off[p] = static_cast<int>(a & 15);
      nvec[p] = (off[p] + len + 15) / 16;
    }
    uint4 v[W][2];
#pragma unroll
    for (int p = 0; p < W; ++p) {
      if (t < nvec[p]) v[p][0] = __ldg(src[p] + t);
      if (t + NTHREADS < nvec[p]) v[p][1] = __ldg(src[p] + t + NTHREADS);
    }
#pragma unroll
    for (int p = 0; p < W; ++p) {
      if (t < nvec[p]) stage[p][t] = v[p][0];
      if (t + NTHREADS < nvec[p]) stage[p][t + NTHREADS] = v[p][1];
    }
    __syncthreads();

    // group q of the chunk: plane p's 4 bytes are the staged words
    // off[p] / 4 + q and the one after, shifted right by 8 (off[p] % 4)
    // bits (a shift of 0 takes the first word alone)
    int4* ov = reinterpret_cast<int4*>(orow + i0);
#pragma unroll
    for (int j = 0; j < DEC_CHUNK / (4 * NTHREADS); ++j) {
      const int q = t + j * NTHREADS;
      if (4 * q >= len) break;
      uint32_t b[4] = {0u, 0u, 0u, 0u};   // b[p]: plane p's 4 bytes
#pragma unroll
      for (int p = 0; p < W; ++p) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(stage[p]);
        const int at = off[p] / 4 + q;
        b[p] = __funnelshift_r(w[at], w[at + 1], 8 * (off[p] % 4));
      }
      // 4 x 4 byte transpose: element e = bytes e of b[0], b[1], b[2], b[3]
      const uint32_t lo01 = __byte_perm(b[0], b[1], 0x5140);
      const uint32_t hi01 = __byte_perm(b[0], b[1], 0x7362);
      const uint32_t lo23 = __byte_perm(b[2], b[3], 0x5140);
      const uint32_t hi23 = __byte_perm(b[2], b[3], 0x7362);
      ov[q] = make_int4(static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                        static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x7632)));
    }
    __syncthreads();   // the next row's chunk reuses the stage
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

// in uint8 [rows, width * k], row r at in + r * in_stride bytes (any
// alignment) -> out int32 [rows, k], contiguous and 16-byte aligned
// (cudaErrorMisalignedAddress otherwise, and cudaErrorInvalidValue for
// in_stride < width * k or width * k >= 2^31, both without a launch).
int bp_narrow_decode(const uint8_t* in, long long in_stride, int32_t* out,
                     long long rows, long long k, int width, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (width * k >= (1LL << 31) || (rows > 1 && in_stride < width * k))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((k + DEC_CHUNK - 1) / DEC_CHUNK),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (width == 2)
    narrow_decode_kernel<2><<<grid, NTHREADS, 0, s>>>(in, in_stride, out,
                                                      rows, kk);
  else if (width == 3)
    narrow_decode_kernel<3><<<grid, NTHREADS, 0, s>>>(in, in_stride, out,
                                                      rows, kk);
  else
    narrow_decode_kernel<4><<<grid, NTHREADS, 0, s>>>(in, in_stride, out,
                                                      rows, kk);
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
