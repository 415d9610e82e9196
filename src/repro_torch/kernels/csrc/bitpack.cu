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
//       uint8 [R, n] of {0,1}, any n -> uint8 [R, ceil(n/8)],
//       out[e] = sum_l in[8e + l] << l over the row's bits, LSB first; the
//       bits past n in a row's last byte are zero (the reference pads each
//       slice with zeros before its pack_bits). The kernel takes bit 0 of
//       each input byte.
//   * bp_unpack_bits -> unpack_bits / _unpack_bits_kernel:
//       uint8 [R, n] -> uint8 [R, 8n], out[8e + l] = (in[e] >> l) & 1.
//   * bp_natural_decode: the same body as bp_unpack_bits with another
//       epilogue: codes uint8 [R, k] and packed signs uint8 [R, ceil(k/8)]
//       -> the bf16 bits (code << 7) - (sign << 15) [R, k]. The reference
//       computes this decode in jnp after its unpack_bits
//       (src/repro/kernels/ops.py:215), which XLA fuses into one pass.
//
// Rows are independent messages (one per worker and stack slice), so each
// kernel takes a whole parameter leaf in one launch.
//
// What bounds them on this card, and what the design does about it:
//   Each does at most ~4 integer operations per byte it moves (address
//   arithmetic aside), below the ~5 INT32 operations an H100 SXM issues in
//   the time it moves one byte of HBM (16.7 T ops/s against 3.35 TB/s), so
//   all of them are bound by bytes. The TPU kernels express the
//   8:1 bit folds as matmuls against selector matrices because the TPU's
//   vector unit has no cheap lane shuffles; here a multiply folds the low
//   bits of a word's 4 bytes into a nibble, and spreads a nibble over 4
//   bytes. Loads and stores are aligned 16-byte vectors, neighbouring
//   threads on neighbouring addresses; a store of one byte per thread ran
//   at a tenth of the memory rate on an H100.
//
// Rows in place. The wire's stage buffer is [n_workers, stage_nbytes];
// a leaf's region in it is [n_workers, n_stack, slice_nbytes], and a
// codec's column of that region [n_workers, n_stack, nbytes]. So the row
// of worker w and stack slice j (row r = w * n_stack + j of the R =
// n_workers * n_stack rows) starts at
//     base + w * s_worker + j * s_slice
// bytes, at any alignment (row lengths and strides are odd byte counts:
// k = 58,983 on nanogpt). narrow_encode writes its planes there;
// narrow_decode, pack_bits, unpack_bits and natural_decode read there
// (natural_decode its codes and its signs, each at its own two strides).
// The grid is 3-D, (chunk of the row, j, w), so no thread divides to find
// its row: a first build that took r / n_stack and r % n_stack in every
// thread ran unpack_bits (one element a thread) 50% slower on an H100. A
// contiguous [R, n] array is the case n_workers = 1, n_stack = R, s_slice
// = n.
//
// pack_bits packs ragged rows (the sign planes of [24, 58,983] leaves, so
// row r starts at byte 58,983 r: no alignment holds), built like
// narrow_decode:
//   * the row and the chunk of the row (PACK_CHUNK output bytes) come from
//     the grid; the chunk starts where the output row is 16-byte aligned,
//     and the at most 15 + 15 + 1 bytes at the row's ends (the last one
//     ragged) are packed one at a time;
//   * the chunk's 16 KB input span is loaded as aligned 16-byte vectors
//     (4-5 a thread, all issued before the first is used); each vector
//     folds to 16 bits, so the span becomes a bit stream of 2 KB in shared
//     memory. The input's misalignment is then a shift of that stream by
//     off < 16 bits, not of the bytes;
//   * each output 16-byte word is 5 staged words funnel-shifted by off and
//     stored whole. No store touches a byte outside the row.
//
// unpack_bits and natural_decode are one body with two epilogues:
//   * the row and the chunk of the row come from the grid; groups start
//     where the output row is 16-byte aligned (bf16 rows start at 2 r k
//     bytes), the at most 2 (G - 1) elements at the row's ends one at a
//     time;
//   * the chunk's sign bytes (and for natural_decode its code bytes) start
//     at any byte, so the block stages them in shared memory with aligned
//     16-byte loads, all issued before the first store to shared memory;
//   * each thread takes groups of one 16-byte output word: 16 sign bits
//     spread to 16 bytes (unpack_bits), or 8 codes and 8 sign bits built
//     into 8 bf16 values (natural_decode), read as staged words
//     funnel-shifted to the group's bit and byte.
//   natural_decode replaces unpack_bits, a slice and the decode's four
//   elementwise PyTorch operations (~44 bytes an element through memory)
//   by one pass of 3.125 bytes an element: the {0,1} plane never exists.

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
constexpr int DEC_CHUNK = 4096;   // narrow_decode: elements a block
constexpr int ENC_CHUNK = 4096;   // narrow_encode: elements a block
constexpr int MAX_GRID_YZ = 65535;   // grid limit in y and z
constexpr int PACK_CHUNK = 2048;   // pack_bits: output bytes a block
// unpack body: 16-byte output groups a thread (bits: 16 elements a group,
// natural_decode: 8)
constexpr int UNPACK_BIT_GROUPS = 4;
constexpr int UNPACK_NAT_GROUPS = 2;

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

// fold4: bit 0 of each of the word's 4 bytes, LSB first (no carries: the
// partial sums below byte 3 stay under 16)
__device__ __forceinline__ uint32_t fold4(uint32_t w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

// Row (w, j) of in (n bytes of {0,1}) starts at in + w * s_worker + j *
// s_slice, at any alignment; of out (nb = ceil(n / 8) bytes) at out + (w *
// n_stack + j) * nb, and out is 16-byte aligned. Block (x, y, z) packs chunk
// x (PACK_CHUNK output bytes) of the rows (z, y), (z, y + gridDim.y), ...,
// (z + gridDim.z, y), ...
__global__ void __launch_bounds__(NTHREADS)
    pack_bits_kernel(const uint8_t* __restrict__ in, long long n_workers,
                     long long n_stack, long long s_worker, long long s_slice,
                     uint8_t* __restrict__ out, int n) {
  // the chunk's input span, 8 PACK_CHUNK bytes from any alignment, is at
  // most NVEC aligned 16-byte vectors; each folds to 16 bits of the span's
  // bit stream (bit b = bit 0 of the span's byte b)
  constexpr int NVEC = 8 * PACK_CHUNK / 16 + 1;
  constexpr int PER_THREAD = (NVEC + NTHREADS - 1) / NTHREADS;
  __shared__ __align__(16) uint32_t stream[(NVEC + 1) / 2 + 4];
  const int t = threadIdx.x;
  const int nb = (n + 7) / 8, full = n / 8;   // output bytes; whole ones
  for (long long w = blockIdx.z; w < n_workers; w += gridDim.z)
  for (long long j = blockIdx.y; j < n_stack; j += gridDim.y) {
    const uint8_t* row = in + w * s_worker + j * s_slice;
    uint8_t* orow = out + (w * n_stack + j) * nb;
    // aligned 16-byte output words from byte `head` on; bytes [0, head) and
    // [body_end, nb) one at a time (the last may hold fewer than 8 bits,
    // the rest of it zero)
    const int head = min(
        static_cast<int>((16 - reinterpret_cast<uintptr_t>(orow) % 16) % 16),
        full);
    const int body_end = head + 16 * ((full - head) / 16);
    if (blockIdx.x == 0 && t < head + (nb - body_end)) {
      const int e = t < head ? t : body_end + (t - head);
      uint32_t acc = 0;
      for (int l = 0; l < 8 && 8 * e + l < n; ++l)
        acc |= (row[8 * e + l] & 1u) << l;
      orow[e] = static_cast<uint8_t>(acc);
    }
    const int e0 = head + blockIdx.x * PACK_CHUNK;   // the same for the block
    if (e0 >= body_end) continue;
    const int len = min(PACK_CHUNK, body_end - e0);   // a multiple of 16

    // input bytes [8 e0, 8 (e0 + len)) from the aligned vector that holds
    // the first of them, `off` bytes into it; the first and last vectors
    // may reach outside the row, never outside the aligned vectors that
    // hold its bytes. All loads are issued before the first is used.
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + 8LL * e0);
    const uint4* src = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
    const int off = static_cast<int>(a & 15);
    const int nvec = (off + 8 * len + 15) / 16;
    uint4 v[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (t + i * NTHREADS < nvec) v[i] = __ldg(src + t + i * NTHREADS);
    uint16_t* half = reinterpret_cast<uint16_t*>(stream);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (t + i * NTHREADS < nvec)
        half[t + i * NTHREADS] = static_cast<uint16_t>(
            fold4(v[i].x) | fold4(v[i].y) << 4 | fold4(v[i].z) << 8 |
            fold4(v[i].w) << 12);
    __syncthreads();

    // output word q (16 bytes) of the chunk: bits [128 q + off, + 128) of
    // the stream, 5 staged words funnel-shifted by off (< 16) bits
    for (int q = t; 16 * q < len; q += NTHREADS) {
      const uint4 s = reinterpret_cast<const uint4*>(stream)[q];
      const uint32_t s4 = stream[4 * q + 4];
      reinterpret_cast<uint4*>(orow + e0)[q] = make_uint4(
          __funnelshift_r(s.x, s.y, off), __funnelshift_r(s.y, s.z, off),
          __funnelshift_r(s.z, s.w, off), __funnelshift_r(s.w, s4, off));
    }
    __syncthreads();   // the next row's chunk reuses the stream
  }
}

// Two bf16 bit patterns (code << 7) | (sign << 15), elements 0 and 1 of c's
// low bytes and s's low bits, as one word (element 0 in the low half). The
// code fills bits 7-14, so the reference's (code << 7) - (sign << 15) is the
// same 16 bits.
__device__ __forceinline__ uint32_t natural_pair(uint32_t c, uint32_t s) {
  return (__byte_perm(c, 0, 0x4140) << 7) | ((s & 1u) << 15) |
         ((s & 2u) << 30);
}

// 4 bits -> 4 bytes of {0, 1}, bit l to byte l (the shifted copies of the
// nibble do not overlap, so the product is their OR)
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return ((nibble & 0xFu) * 0x00204081u) & 0x01010101u;
}

// One body, two epilogues. Element e of row (w, j) is bit e of the packed
// sign row at sign + w * s_worker + j * s_slice (any alignment), LSB first.
//   NATURAL = false (unpack_bits): out[e] = that bit, as a byte; k = 8 nb.
//   NATURAL = true (natural_decode): out[e] = the bf16 bits (code[e] << 7)
//     | (bit << 15), code[e] the byte e of the code row at code + w *
//     c_worker + j * c_slice (any alignment).
// Row r = w * n_stack + j of out starts at out + r * k elements, and out is
// 16-byte aligned. Block (x, y, z) takes chunk x (CH elements) of the rows
// (z, y), (z, y + gridDim.y), ..., (z + gridDim.z, y), ...
template <bool NATURAL>
__global__ void __launch_bounds__(NTHREADS)
    unpack_rows_kernel(const uint8_t* __restrict__ sign, long long s_worker,
                       long long s_slice, const uint8_t* __restrict__ code,
                       long long c_worker, long long c_slice,
                       long long n_workers, long long n_stack,
                       uint8_t* __restrict__ out, int k) {
  constexpr int EB = NATURAL ? 2 : 1;   // output bytes an element
  constexpr int G = 16 / EB;            // elements a group: one 16-byte store
  constexpr int CH = G * (NATURAL ? UNPACK_NAT_GROUPS : UNPACK_BIT_GROUPS) *
                     NTHREADS;          // elements a block
  // the chunk's sign bytes (at most CH / 8 + 1) and code bytes (CH), from
  // any alignment, span at most SVEC and CVEC aligned 16-byte vectors: SPT
  // and CPT loads a thread. The stages hold one vector more, which the
  // funnel shifts of the last group may read.
  constexpr int SVEC = CH / 128 + 1;
  constexpr int CVEC = NATURAL ? CH / 16 + 1 : 0;
  constexpr int SPT = (SVEC + NTHREADS - 1) / NTHREADS;
  constexpr int CPT = NATURAL ? (CVEC + NTHREADS - 1) / NTHREADS : 1;
  __shared__ uint4 sstage[SVEC + 1];
  __shared__ uint4 cstage[CVEC + 1];
  const int t = threadIdx.x;
  for (long long w = blockIdx.z; w < n_workers; w += gridDim.z)
  for (long long j = blockIdx.y; j < n_stack; j += gridDim.y) {
    const long long r = w * n_stack + j;
    const uint8_t* srow = sign + w * s_worker + j * s_slice;
    const uint8_t* crow = NATURAL ? code + w * c_worker + j * c_slice
                                  : nullptr;
    uint8_t* orow = out + r * k * EB;
    // groups from element `head` on, each stored as one aligned 16-byte
    // word; elements [0, head) and [body_end, k) one at a time
    const int head = min(static_cast<int>((16 - (r * k * EB) % 16) % 16 / EB),
                         k);
    const int body_end = head + G * ((k - head) / G);
    if (blockIdx.x == 0 && t < head + (k - body_end)) {
      const int e = t < head ? t : body_end + (t - head);
      const uint32_t s = (srow[e >> 3] >> (e & 7)) & 1u;
      if constexpr (NATURAL)
        reinterpret_cast<uint16_t*>(orow)[e] =
            static_cast<uint16_t>(static_cast<uint32_t>(crow[e]) << 7 |
                                  s << 15);
      else
        orow[e] = static_cast<uint8_t>(s);
    }
    const int i0 = head + blockIdx.x * CH;   // the same for the block
    if (i0 >= body_end) continue;
    const int len = min(CH, body_end - i0);   // a multiple of G

    // stage the sign bytes [i0 / 8, (i0 + len - 1) / 8] and the code bytes
    // [i0, i0 + len) from the aligned vectors that hold the first of them;
    // element i0 is bit `sbit` of the staged sign stream, its code byte
    // `coff` of the staged codes. All loads are issued before any store to
    // shared memory.
    const uintptr_t sa = reinterpret_cast<uintptr_t>(srow + (i0 >> 3));
    const uint4* ssrc = reinterpret_cast<const uint4*>(sa & ~uintptr_t(15));
    const int sbit = 8 * static_cast<int>(sa & 15) + (i0 & 7);
    const int snvec = (static_cast<int>(sa & 15) + ((i0 + len - 1) >> 3) -
                       (i0 >> 3) + 16) / 16;
    uint4 sv[SPT], cv[CPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (t + i * NTHREADS < snvec) sv[i] = __ldg(ssrc + t + i * NTHREADS);
    int coff = 0;
    if constexpr (NATURAL) {
      const uintptr_t ca = reinterpret_cast<uintptr_t>(crow + i0);
      const uint4* csrc = reinterpret_cast<const uint4*>(ca & ~uintptr_t(15));
      coff = static_cast<int>(ca & 15);
      const int cnvec = (coff + len + 15) / 16;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        if (t + i * NTHREADS < cnvec) cv[i] = __ldg(csrc + t + i * NTHREADS);
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        if (t + i * NTHREADS < cnvec) cstage[t + i * NTHREADS] = cv[i];
    }
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (t + i * NTHREADS < snvec) sstage[t + i * NTHREADS] = sv[i];
    __syncthreads();

    // group q of the chunk: its G sign bits are the staged words at bit
    // sbit + G q, funnel-shifted; its 8 codes (NATURAL) three staged words
    // at byte coff + 8 q, funnel-shifted
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(sstage);
    uint4* ov = reinterpret_cast<uint4*>(orow + EB * i0);
#pragma unroll
    for (int g = 0; g < CH / (G * NTHREADS); ++g) {
      const int q = t + g * NTHREADS;
      if (G * q >= len) break;
      const int bs = sbit + G * q;
      const uint32_t b = __funnelshift_r(sw[bs >> 5], sw[(bs >> 5) + 1],
                                         bs & 31);
      if constexpr (NATURAL) {
        const int cb = coff + 8 * q;
        const uint32_t* cw =
            reinterpret_cast<const uint32_t*>(cstage) + (cb >> 2);
        const int sh = 8 * (cb & 3);
        const uint32_t c0 = __funnelshift_r(cw[0], cw[1], sh);
        const uint32_t c1 = __funnelshift_r(cw[1], cw[2], sh);
        ov[q] = make_uint4(natural_pair(c0, b), natural_pair(c0 >> 16, b >> 2),
                           natural_pair(c1, b >> 4),
                           natural_pair(c1 >> 16, b >> 6));
      } else {
        ov[q] = make_uint4(spread4(b), spread4(b >> 4), spread4(b >> 8),
                           spread4(b >> 12));
      }
    }
    __syncthreads();   // the next row's chunk reuses the stages
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

// n bytes of {0, 1} for row (w, j) at in + w * s_worker + j * s_slice (any
// alignment) -> out uint8 [n_workers * n_stack, ceil(n / 8)], LSB first,
// the bits past n in each row's last byte zero; out contiguous and 16-byte
// aligned (cudaErrorMisalignedAddress otherwise, and cudaErrorInvalidValue
// for n >= 2^31, both without a launch).
int bp_pack_bits(const uint8_t* in, long long n_workers, long long n_stack,
                 long long s_worker, long long s_slice, uint8_t* out,
                 long long n, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n / 8 + PACK_CHUNK - 1) / PACK_CHUNK;
  pack_bits_kernel<<<row_grid(chunks > 0 ? chunks : 1, n_stack, n_workers),
                     NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, n_workers, n_stack, s_worker, s_slice, out, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// n bytes for row (w, j) at in + w * s_worker + j * s_slice (any
// alignment) -> out uint8 [n_workers * n_stack, 8 * n] of {0, 1}; out
// 16-byte aligned (cudaErrorMisalignedAddress otherwise, and
// cudaErrorInvalidValue for 8 n >= 2^31, both without a launch).
int bp_unpack_bits(const uint8_t* in, long long n_workers, long long n_stack,
                   long long s_worker, long long s_slice, uint8_t* out,
                   long long n, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (8 * n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long ch = 16 * UNPACK_BIT_GROUPS * NTHREADS;
  unpack_rows_kernel<false>
      <<<row_grid((8 * n + ch - 1) / ch, n_stack, n_workers), NTHREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          in, s_worker, s_slice, nullptr, 0, 0, n_workers, n_stack, out,
          static_cast<int>(8 * n));
  return static_cast<int>(cudaGetLastError());
}

// k code bytes for row (w, j) at code + w * c_worker + j * c_slice and its
// ceil(k / 8) packed sign bytes at sign + w * s_worker + j * s_slice (any
// alignments) -> out bf16 bits [n_workers * n_stack, k], (code << 7) |
// (sign << 15); out 16-byte aligned (cudaErrorMisalignedAddress otherwise,
// and cudaErrorInvalidValue for k >= 2^30, both without a launch).
int bp_natural_decode(const uint8_t* code, long long c_worker,
                      long long c_slice, const uint8_t* sign,
                      long long s_worker, long long s_slice,
                      long long n_workers, long long n_stack, uint16_t* out,
                      long long k, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (k >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const long long ch = 8 * UNPACK_NAT_GROUPS * NTHREADS;
  unpack_rows_kernel<true>
      <<<row_grid((k + ch - 1) / ch, n_stack, n_workers), NTHREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          sign, s_worker, s_slice, code, c_worker, c_slice, n_workers,
          n_stack, reinterpret_cast<uint8_t*>(out), static_cast<int>(k));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
