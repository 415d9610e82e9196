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
// pack_bits needs no row notion: a row of 8k bits packs to a row of k
// bytes, so flat indices line up across rows. unpack_bits reads its rows
// where they lie (below).
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
//
// Rows in place. The wire's stage buffer is [n_workers, stage_nbytes];
// a leaf's region in it is [n_workers, n_stack, slice_nbytes], and a
// codec's column of that region [n_workers, n_stack, nbytes]. So the row
// of worker w and stack slice j (row r = w * n_stack + j of the R =
// n_workers * n_stack rows) starts at
//     base + w * s_worker + j * s_slice
// bytes, at any alignment (row lengths and strides are odd byte counts:
// k = 58,983 on nanogpt). narrow_encode writes its planes there,
// narrow_decode and unpack_bits read there. The grid is 3-D, (chunk of the
// row, j, w), so no thread divides to find its row: a first build that
// took r / n_stack and r % n_stack in every thread ran unpack_bits (one
// element a thread) 50% slower on an H100. A contiguous [R, n] array is
// the case n_workers = 1, n_stack = R, s_slice = n.
//
// narrow_encode is built for bytes in flight and whole 16-byte stores:
//   * the row and the chunk of the row come from the grid, so no element
//     pays a 64-bit division; offsets within a row are 32-bit;
//   * elements go in groups of 4 whose input starts 16-byte aligned (a
//     row's first and last few elements are encoded one at a time), so
//     each group is one int4 load; each thread takes ENC_CHUNK / NTHREADS
//     = 16 elements and issues its 4 loads before it uses any (16 KB a
//     block, ~128 KB an SM at 8 resident blocks);
//   * __byte_perm transposes a group's 4 elements x 4 bytes into one
//     32-bit word per plane, which goes to the plane's span of the chunk
//     in shared memory;
//   * each plane's span is then stored as the aligned 16-byte words that
//     lie wholly inside it, each made of 5 shared words funnel-shifted to
//     the span's byte alignment, and the at most 15 + 15 ragged bytes at
//     its ends one at a time. No store touches a byte outside the span,
//     so the planes go straight into a column of the stage buffer between
//     other leaves' bytes.
//
// narrow_decode is its inverse, built the same way:
//   * the row and the chunk of the row come from the grid;
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
constexpr int ENC_CHUNK = 4096;   // narrow_encode: elements a block
constexpr int MAX_GRID_YZ = 65535;   // grid limit in y and z

inline int blocks_for(long long n) {
  const long long b = (n + NTHREADS - 1) / NTHREADS;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

// Row (w, j) of idx starts at idx + (w * n_stack + j) * k; of out (width
// planes of k bytes) at out + w * s_worker + j * s_slice. Block (x, y, z)
// encodes chunk x (ENC_CHUNK elements) of the rows (z, y), (z, y +
// gridDim.y), ..., (z + gridDim.z, y), ...
template <int W>
__global__ void __launch_bounds__(NTHREADS)
    narrow_encode_kernel(const int32_t* __restrict__ idx,
                         uint8_t* __restrict__ out, long long n_workers,
                         long long n_stack, long long s_worker,
                         long long s_slice, int k) {
  constexpr int PER_THREAD = ENC_CHUNK / (4 * NTHREADS);   // groups
  // plane p's bytes of the chunk as words; one more word for the funnel
  // shift of the last 16-byte store
  __shared__ uint32_t stage[W][ENC_CHUNK / 4 + 1];
  const int t = threadIdx.x;
  for (long long w = blockIdx.z; w < n_workers; w += gridDim.z)
  for (long long j = blockIdx.y; j < n_stack; j += gridDim.y) {
    const int32_t* row = idx + (w * n_stack + j) * k;
    uint8_t* orow = out + w * s_worker + j * s_slice;
    // groups of 4 from element `head` on, each starting 16-byte aligned in
    // idx; elements [0, head) and [body_end, k) one at a time
    const int head = min(
        static_cast<int>((16 - reinterpret_cast<uintptr_t>(row) % 16) % 16 / 4),
        k);
    const int body_end = head + 4 * ((k - head) / 4);
    if (blockIdx.x == 0 && t < head + (k - body_end)) {
      const int i = t < head ? t : body_end + (t - head);
      const uint32_t v = static_cast<uint32_t>(row[i]);
#pragma unroll
      for (int p = 0; p < W; ++p) orow[p * k + i] = (v >> (8 * p)) & 0xFF;
    }
    const int i0 = head + blockIdx.x * ENC_CHUNK;   // the same for the block
    if (i0 >= body_end) continue;
    const int len = min(ENC_CHUNK, body_end - i0);   // a multiple of 4

    // group q of the chunk -> word q of each plane's stage; all loads are
    // issued before the first store to shared memory
    const int4* src = reinterpret_cast<const int4*>(row + i0);
    int4 v[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int q = t + j * NTHREADS;
      if (4 * q < len) v[j] = __ldg(src + q);
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int q = t + j * NTHREADS;
      if (4 * q >= len) break;
      // 4 x 4 byte transpose: plane p = bytes p of the 4 elements
      const uint32_t e0 = v[j].x, e1 = v[j].y, e2 = v[j].z, e3 = v[j].w;
      const uint32_t lo01 = __byte_perm(e0, e1, 0x5140);
      const uint32_t hi01 = __byte_perm(e0, e1, 0x7362);
      const uint32_t lo23 = __byte_perm(e2, e3, 0x5140);
      const uint32_t hi23 = __byte_perm(e2, e3, 0x7362);
      stage[0][q] = __byte_perm(lo01, lo23, 0x5410);
      stage[1][q] = __byte_perm(lo01, lo23, 0x7632);
      if constexpr (W > 2) stage[2][q] = __byte_perm(hi01, hi23, 0x5410);
      if constexpr (W > 3) stage[3][q] = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();

    // plane p's span [i0, i0 + len) of the row's plane: d bytes up to its
    // first 16-byte boundary, nfull whole aligned words, then the rest.
    // Word m of the span holds the chunk's bytes d + 16m onwards: staged
    // words (d + 16m) / 4 .. + 4, shifted right by 8 ((d + 16m) % 4) bits
#pragma unroll
    for (int p = 0; p < W; ++p) {
      uint8_t* dst = orow + p * k + i0;
      const int d = min(
          static_cast<int>((16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16),
          len);
      const int nfull = (len - d) / 16;
      const int tail = d + 16 * nfull;
      const uint8_t* sb = reinterpret_cast<const uint8_t*>(stage[p]);
      if (t < d) dst[t] = sb[t];
      if (t >= 32 && t - 32 < len - tail) dst[tail + t - 32] = sb[tail + t - 32];
      if (t < nfull) {
        const int s = d + 16 * t;
        const uint32_t* w = stage[p] + s / 4;
        const int sh = 8 * (s % 4);
        reinterpret_cast<uint4*>(dst + d)[t] = make_uint4(
            __funnelshift_r(w[0], w[1], sh), __funnelshift_r(w[1], w[2], sh),
            __funnelshift_r(w[2], w[3], sh), __funnelshift_r(w[3], w[4], sh));
      }
    }
    __syncthreads();   // the next row's chunk reuses the stage
  }
}

// Row (w, j) of in (width planes of k bytes) starts at in + w * s_worker
// + j * s_slice; of out at out + (w * n_stack + j) * k, and out is 16-byte
// aligned. Block (x, y, z) decodes chunk x (DEC_CHUNK elements) of the
// rows (z, y), (z, y + gridDim.y), ..., (z + gridDim.z, y), ...
template <int W>
__global__ void __launch_bounds__(NTHREADS)
    narrow_decode_kernel(const uint8_t* __restrict__ in, long long n_workers,
                         long long n_stack, long long s_worker,
                         long long s_slice, int32_t* __restrict__ out,
                         int k) {
  // each plane's span of the chunk: DEC_CHUNK bytes from any alignment fit
  // in DEC_CHUNK / 16 + 1 aligned 16-byte vectors
  constexpr int NVEC = DEC_CHUNK / 16 + 1;
  __shared__ uint4 stage[W][NVEC];
  const int t = threadIdx.x;
  for (long long w = blockIdx.z; w < n_workers; w += gridDim.z)
  for (long long j = blockIdx.y; j < n_stack; j += gridDim.y) {
    const long long r = w * n_stack + j;
    const uint8_t* row = in + w * s_worker + j * s_slice;
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

// Row (w, j) of in (n bytes) starts at in + w * s_worker + j * s_slice; of
// out at out + 8 * n * (w * n_stack + j), and out is 8-byte aligned:
// element e of a row writes its 8 output bytes as one word. Block (x, y,
// z) takes elements x, x + gridDim.x, ... (in blocks) of the rows (z, y),
// (z, y + gridDim.y), ..., (z + gridDim.z, y), ...
__global__ void unpack_bits_kernel(const uint8_t* __restrict__ in,
                                   long long n_workers, long long n_stack,
                                   long long s_worker, long long s_slice,
                                   uint8_t* __restrict__ out, long long n) {
  for (long long w = blockIdx.z; w < n_workers; w += gridDim.z)
  for (long long j = blockIdx.y; j < n_stack; j += gridDim.y) {
    const uint8_t* row = in + w * s_worker + j * s_slice;
    uint64_t* orow = reinterpret_cast<uint64_t*>(out) + (w * n_stack + j) * n;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < n; e += (long long)gridDim.x * blockDim.x) {
      const uint32_t b = row[e];
      uint64_t w = 0;
#pragma unroll
      for (int l = 0; l < 8; ++l)
        w |= static_cast<uint64_t>((b >> l) & 1) << (8 * l);   // little-endian
      orow[e] = w;
    }
  }
}

}  // namespace

extern "C" {

inline dim3 row_grid(long long chunks, long long n_stack,
                     long long n_workers) {
  return dim3(static_cast<unsigned>(chunks),
              static_cast<unsigned>(n_stack < MAX_GRID_YZ ? n_stack
                                                          : MAX_GRID_YZ),
              static_cast<unsigned>(n_workers < MAX_GRID_YZ ? n_workers
                                                            : MAX_GRID_YZ));
}

// idx int32 [n_workers * n_stack, k], contiguous -> width planes of k bytes
// for row (w, j) at out + w * s_worker + j * s_slice (any alignment); width
// in {2, 3, 4}. cudaErrorInvalidValue, without a launch, for width * k >=
// 2^31.
int bp_narrow_encode(const int32_t* idx, uint8_t* out, long long n_workers,
                     long long n_stack, long long s_worker, long long s_slice,
                     long long k, int width, void* stream) {
  if (width * k >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid =
      row_grid((k + ENC_CHUNK - 1) / ENC_CHUNK, n_stack, n_workers);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (width == 2)
    narrow_encode_kernel<2><<<grid, NTHREADS, 0, s>>>(
        idx, out, n_workers, n_stack, s_worker, s_slice, kk);
  else if (width == 3)
    narrow_encode_kernel<3><<<grid, NTHREADS, 0, s>>>(
        idx, out, n_workers, n_stack, s_worker, s_slice, kk);
  else
    narrow_encode_kernel<4><<<grid, NTHREADS, 0, s>>>(
        idx, out, n_workers, n_stack, s_worker, s_slice, kk);
  return static_cast<int>(cudaGetLastError());
}

// width planes of k bytes for row (w, j) at in + w * s_worker + j *
// s_slice (any alignment) -> out int32 [n_workers * n_stack, k],
// contiguous and 16-byte aligned (cudaErrorMisalignedAddress otherwise,
// and cudaErrorInvalidValue for width * k >= 2^31, both without a launch).
int bp_narrow_decode(const uint8_t* in, long long n_workers, long long n_stack,
                     long long s_worker, long long s_slice, int32_t* out,
                     long long k, int width, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (width * k >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid =
      row_grid((k + DEC_CHUNK - 1) / DEC_CHUNK, n_stack, n_workers);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (width == 2)
    narrow_decode_kernel<2><<<grid, NTHREADS, 0, s>>>(
        in, n_workers, n_stack, s_worker, s_slice, out, kk);
  else if (width == 3)
    narrow_decode_kernel<3><<<grid, NTHREADS, 0, s>>>(
        in, n_workers, n_stack, s_worker, s_slice, out, kk);
  else
    narrow_decode_kernel<4><<<grid, NTHREADS, 0, s>>>(
        in, n_workers, n_stack, s_worker, s_slice, out, kk);
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

// n bytes for row (w, j) at in + w * s_worker + j * s_slice -> out uint8
// [n_workers * n_stack, 8 * n] of {0, 1}; out 8-byte aligned
// (cudaErrorMisalignedAddress otherwise, without a launch).
int bp_unpack_bits(const uint8_t* in, long long n_workers, long long n_stack,
                   long long s_worker, long long s_slice, uint8_t* out,
                   long long n, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  unpack_bits_kernel<<<row_grid(blocks_for(n), n_stack, n_workers), NTHREADS,
                       0, static_cast<cudaStream_t>(stream)>>>(
      in, n_workers, n_stack, s_worker, s_slice, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
