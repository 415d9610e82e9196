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
//   an H100 SXM). Reaching that rate needs ~15 KB of loads in flight per SM
//   (Little's law: ~2 MB over 132 SMs at ~0.6 us of latency). One element a
//   thread (a 2-byte load, two 1-byte stores) kept ~4 KB in flight and ran
//   at ~0.9 TB/s. So each thread takes groups of 8 elements: one 16-byte
//   load for bf16 (two for f32), then the 8 codes as one 8-byte store and
//   the 8 signs as another. The grid is sized to the card (SMs x resident
//   blocks) and walks the input in a grid-stride loop whose body issues
//   the loads of UNROLL groups before it computes any: with 8 resident
//   256-thread blocks an SM keeps >= 32 KB of loads in flight.
//   The vector body needs the input 16-byte aligned and both outputs
//   8-byte aligned at the same element. Scalar elements in front of it
//   reach that point and scalar elements behind it finish the ragged end;
//   where no element aligns all three (a bf16 input whose address is not
//   congruent to the outputs'), the scalar loop takes the whole range. All
//   of it runs in the one launch.
//   f32 input is cast as XLA casts it (bf16_bits below): round to nearest
//   even on the bits, which is x.to(torch.bfloat16) for every value that
//   is not a NaN, and every NaN to sign | 0x7FC0. __float2bfloat16_rn
//   would give PTX's canonical NaN and drop the sign.
//
// nat_to_bf16 is that cast alone, f32 [n] -> bf16 [n]: the wire's f32 ->
// bf16 cast of the EF21 difference (repro_torch.kernels.natural_pack.
// to_bf16; the reference casts with XLA's convert, the
// diff.astype(wire_dtype) of src/repro/core/error_feedback.py). It moves
// 6 bytes an element, as PyTorch's own cast does; PyTorch's cast followed
// by a torch.where on isnan takes several more passes over the tensor.
// Same structure as the encode: groups of 8 (two 16-byte loads, one
// 16-byte store), UNROLL groups in flight, a grid of SMs x resident blocks.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int VEC = 8;      // elements per group
constexpr int UNROLL = 2;   // groups whose loads are in flight together
constexpr int MAX_DEVICES = 64;

// f32 bits -> bf16 bits: every NaN -> sign | 0x7FC0, every other value
// rounded to nearest even (a carry out of the mantissa rounds to inf)
__device__ __forceinline__ uint32_t bf16_bits(uint32_t u) {
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return ((u >> 16) & 0x8000u) | 0x7FC0u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ uint32_t nat_code(uint32_t bits) {
  const uint32_t exp = (bits >> 7) & 0xFF;
  const uint32_t rounded = min(exp + ((bits >> 6) & 1), 254u);
  return (bits & 0x7FFF) == 0 ? 0u : rounded;
}

// Elements [0, head) and [head + VEC * groups, n) one at a time; the groups
// in between VEC at a time, from x + head (16-byte aligned) into
// code + head and sign + head (8-byte aligned).
template <bool BF16>
__global__ void __launch_bounds__(NTHREADS)
    natural_encode_kernel(const void* __restrict__ x,
                          uint8_t* __restrict__ code,
                          uint8_t* __restrict__ sign, long long n,
                          long long head, long long groups) {
  constexpr int LOADS = BF16 ? 1 : 2;   // 16-byte loads per group
  const long long tid = blockIdx.x * (long long)NTHREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * NTHREADS;
  const long long body_end = head + VEC * groups;

  for (long long e = tid; e < head + (n - body_end); e += nthreads) {
    const long long i = e < head ? e : body_end + (e - head);
    const uint32_t bits =
        BF16 ? static_cast<const uint16_t*>(x)[i]
             : bf16_bits(static_cast<const uint32_t*>(x)[i]);
    code[i] = static_cast<uint8_t>(nat_code(bits));
    sign[i] = static_cast<uint8_t>(bits >> 15);
  }

  const uint4* xv = reinterpret_cast<const uint4*>(
      static_cast<const char*>(x) + head * (BF16 ? 2 : 4));
  uint2* cv = reinterpret_cast<uint2*>(code + head);
  uint2* sv = reinterpret_cast<uint2*>(sign + head);
  for (long long g = tid; g < groups; g += UNROLL * nthreads) {
    uint4 raw[UNROLL][LOADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long gu = g + u * nthreads;
      if (gu < groups) {
#pragma unroll
        for (int l = 0; l < LOADS; ++l) raw[u][l] = __ldg(xv + gu * LOADS + l);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long gu = g + u * nthreads;
      if (gu >= groups) break;
      uint32_t bits[VEC];
      if (BF16) {
        const uint32_t w[4] = {raw[u][0].x, raw[u][0].y, raw[u][0].z,
                               raw[u][0].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // little-endian: low half first
          bits[2 * j] = w[j] & 0xFFFF;
          bits[2 * j + 1] = w[j] >> 16;
        }
      } else {
#pragma unroll
        for (int l = 0; l < LOADS; ++l) {
          bits[4 * l + 0] = bf16_bits(raw[u][l].x);
          bits[4 * l + 1] = bf16_bits(raw[u][l].y);
          bits[4 * l + 2] = bf16_bits(raw[u][l].z);
          bits[4 * l + 3] = bf16_bits(raw[u][l].w);
        }
      }
      uint32_t c[2] = {0, 0}, s[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        c[j / 4] |= nat_code(bits[j]) << (8 * (j % 4));
        s[j / 4] |= (bits[j] >> 15) << (8 * (j % 4));
      }
      cv[gu] = make_uint2(c[0], c[1]);
      sv[gu] = make_uint2(s[0], s[1]);
    }
  }
}

// SMs x resident blocks of `kernel` on the current device, asked once per
// device (`cached` belongs to the kernel).
int resident_blocks(const void* kernel, int (&cached)[MAX_DEVICES]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) dev = MAX_DEVICES - 1;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS,
                                                  0);
    cached[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return cached[dev];
}

// Blocks for `threads` threads, at most `cap`, at least 1.
int grid_for(long long threads, int cap) {
  const long long want = (threads + NTHREADS - 1) / NTHREADS;
  return static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
}

template <bool BF16>
int launch(const void* x, uint8_t* code, uint8_t* sign, long long n,
           cudaStream_t s) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ca = reinterpret_cast<uintptr_t>(code);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(sign);
  // the first element at which code and sign are 8-byte aligned, if the
  // input is 16-byte aligned there too; else no vector body
  long long head = static_cast<long long>((8 - ca % 8) % 8);
  const bool aligns = (sa + head) % 8 == 0 &&
                      (xa + head * (BF16 ? 2 : 4)) % 16 == 0;
  if (!aligns || head > n) head = n;
  const long long groups = (n - head) / VEC;
  const long long n_scalar = n - VEC * groups;
  const long long vec_threads = (groups + UNROLL - 1) / UNROLL;
  const long long threads = vec_threads > n_scalar ? vec_threads : n_scalar;
  static int cached[MAX_DEVICES] = {};
  const int blocks = grid_for(
      threads, resident_blocks(
                   reinterpret_cast<const void*>(natural_encode_kernel<BF16>),
                   cached));
  natural_encode_kernel<BF16><<<blocks, NTHREADS, 0, s>>>(x, code, sign, n,
                                                          head, groups);
  return static_cast<int>(cudaGetLastError());
}

// Elements [VEC * groups, n) one at a time; the groups VEC at a time, from
// x (16-byte aligned) into out (16-byte aligned).
__global__ void __launch_bounds__(NTHREADS)
    to_bf16_kernel(const uint32_t* __restrict__ x, uint16_t* __restrict__ out,
                   long long n, long long groups) {
  const long long tid = blockIdx.x * (long long)NTHREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * NTHREADS;
  for (long long i = VEC * groups + tid; i < n; i += nthreads)
    out[i] = static_cast<uint16_t>(bf16_bits(x[i]));

  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long g = tid; g < groups; g += UNROLL * nthreads) {
    uint4 raw[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long gu = g + u * nthreads;
      if (gu < groups) {
        raw[u][0] = __ldg(xv + 2 * gu);
        raw[u][1] = __ldg(xv + 2 * gu + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long gu = g + u * nthreads;
      if (gu >= groups) break;
      // little-endian: element 2j in the low half of word j
      ov[gu] = make_uint4(
          bf16_bits(raw[u][0].x) | bf16_bits(raw[u][0].y) << 16,
          bf16_bits(raw[u][0].z) | bf16_bits(raw[u][0].w) << 16,
          bf16_bits(raw[u][1].x) | bf16_bits(raw[u][1].y) << 16,
          bf16_bits(raw[u][1].z) | bf16_bits(raw[u][1].w) << 16);
    }
  }
}

}  // namespace

extern "C" {

// x [n] f32 (is_bf16 == 0) or bf16 (is_bf16 == 1) -> code, sign uint8 [n].
int nat_encode(const void* x, int is_bf16, uint8_t* code, uint8_t* sign,
               long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<true>(x, code, sign, n, s)
                 : launch<false>(x, code, sign, n, s);
}

// x f32 [n] -> out bf16 [n] (as 16-bit words), out 16-byte aligned
// (cudaErrorMisalignedAddress otherwise, without a launch). An x that is
// not 16-byte aligned is cast one element at a time.
int nat_to_bf16(const void* x, void* out, long long n, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long groups =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 ? n / VEC : 0;
  const long long vec_threads = (groups + UNROLL - 1) / UNROLL;
  const long long n_scalar = n - VEC * groups;
  static int cached[MAX_DEVICES] = {};
  const int blocks = grid_for(
      vec_threads > n_scalar ? vec_threads : n_scalar,
      resident_blocks(reinterpret_cast<const void*>(to_bf16_kernel), cached));
  to_bf16_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint16_t*>(out), n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
