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
// nat_add_f32 and nat_fold_f32 are the f32 adds through which the port
// moves its estimates (repro_torch.kernels.natural_pack.add_f32 and
// fold_f32): the EF21 and EF21-P estimate E + delta, the rejoin's replay,
// and the server's fold g + (sum_j d_j) / count. They follow XLA's NaN
// rule on the CPU, where the reference runs: a NaN operand comes out with
// its payload, quieted (| 0x00400000), the first operand's before the
// second's, and a NaN made from operands that are not NaN (inf - inf) is
// 0xFFC00000. PTX's add.f32 gives 0x7FFFFFFF for every NaN result, so
// the operands are tested on their bits around __fadd_rn, __fdiv_rn and
// __fmaf_rn (intrinsics nvcc neither contracts nor reorders). The fold
// sums j = 0, 1, ... from +0.0 (d_0 alone for one worker, as XLA drops a
// one-element reduction); with a host count n it is jnp.mean as XLA
// compiles it, one fma(s, fl(1/n), g) (g + d_0 for one worker), and with
// a device count (the elastic arm's) a division and an add, the
// quotient's NaN first. Both move 4 bytes an element per operand: 12 for
// the add, 4 (n + 2) for the fold, float4 at a time where every pointer is
// 16-byte aligned (and the rows' lengths are multiples of 4), else one
// element at a time. The add takes an operand of fewer elements repeated
// over the output's leading rows (the replay's one delta for every
// worker's W_j). The output may be an input (in place): each element is
// read, then written, by one thread.
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

constexpr uint32_t QUIET = 0x00400000u;
constexpr uint32_t DEFAULT_NAN = 0xFFC00000u;

__device__ __forceinline__ bool is_nan_bits(uint32_t u) {
  return (u & 0x7FFFFFFFu) > 0x7F800000u;
}

// r with XLA's NaN bits: first's NaN quieted, else second's, else r (a NaN
// r from operands that are not NaN -> DEFAULT_NAN)
__device__ __forceinline__ float nan_pick(float first, float second,
                                          float r) {
  const uint32_t a = __float_as_uint(first), b = __float_as_uint(second);
  if (is_nan_bits(a)) return __uint_as_float(a | QUIET);
  if (is_nan_bits(b)) return __uint_as_float(b | QUIET);
  return is_nan_bits(__float_as_uint(r)) ? __uint_as_float(DEFAULT_NAN) : r;
}

__device__ __forceinline__ float add_rule(float a, float b) {
  return nan_pick(a, b, __fadd_rn(a, b));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(add_rule(a.x, b.x), add_rule(a.y, b.y),
                     add_rule(a.z, b.z), add_rule(a.w, b.w));
}

// out[i] = a[i % na] + b[i % nb] (na, nb divide n: an operand of fewer
// elements is repeated over out's leading rows); the float4 body over
// groups [0, groups), the elements [4 * groups, n) one at a time
template <bool BCAST>
__global__ void __launch_bounds__(NTHREADS)
    add_f32_kernel(const float* a, const float* b, float* out, long long n,
                   long long na, long long nb, long long groups) {
  const long long tid = blockIdx.x * (long long)NTHREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * NTHREADS;
  for (long long i = 4 * groups + tid; i < n; i += nthreads)
    out[i] = BCAST ? add_rule(a[i % na], b[i % nb]) : add_rule(a[i], b[i]);
  const float4* av = reinterpret_cast<const float4*>(a);
  const float4* bv = reinterpret_cast<const float4*>(b);
  float4* ov = reinterpret_cast<float4*>(out);
  const long long ga = na / 4, gb = nb / 4;
  for (long long g = tid; g < groups; g += UNROLL * nthreads) {
    float4 ra[UNROLL], rb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long gu = g + u * nthreads;
      if (gu < groups) {
        ra[u] = av[BCAST ? gu % ga : gu];
        rb[u] = bv[BCAST ? gu % gb : gu];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long gu = g + u * nthreads;
      if (gu < groups) ov[gu] = add4(ra[u], rb[u]);
    }
  }
}

// one worker's mean is g + d_0 (XLA drops the product by 1.0: g's NaN
// first); more workers' the fused fma(s, fl(1/n), g), the sum's NaN first
template <bool MEAN>
__device__ __forceinline__ float fold_tail(float s, float g, float recip,
                                           float count, int nw) {
  if (MEAN && nw == 1) return add_rule(g, s);
  if (MEAN) return nan_pick(s, g, __fmaf_rn(s, recip, g));
  const float q = nan_pick(s, count, __fdiv_rn(s, count));
  return nan_pick(q, g, __fadd_rn(q, g));
}

// out[i] = g[i] + (sum_j d[j * n + i]) / count over j < nw; MEAN: the
// count is the host's n (recip = fl(1/n)), else *count on the device
template <bool MEAN>
__global__ void __launch_bounds__(NTHREADS)
    fold_f32_kernel(const float* g, const float* d, float* out, long long n,
                    int nw, long long groups, float recip,
                    const float* count_ptr) {
  const long long tid = blockIdx.x * (long long)NTHREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * NTHREADS;
  const float count = MEAN ? 1.0f : *count_ptr;
  for (long long i = 4 * groups + tid; i < n; i += nthreads) {
    float s = d[i];
    if (nw > 1) {
      s = add_rule(0.0f, s);
      for (int j = 1; j < nw; ++j) s = add_rule(s, d[j * n + i]);
    }
    out[i] = fold_tail<MEAN>(s, g[i], recip, count, nw);
  }
  const float4* gv = reinterpret_cast<const float4*>(g);
  const float4* dv = reinterpret_cast<const float4*>(d);
  float4* ov = reinterpret_cast<float4*>(out);
  const long long row = n / 4;   // float4s a worker's row (n % 4 == 0 here)
  for (long long k = tid; k < groups; k += nthreads) {
    float4 s = dv[k];
    if (nw > 1) {
      s = add4(make_float4(0.0f, 0.0f, 0.0f, 0.0f), s);
      for (int j = 1; j < nw; ++j) s = add4(s, dv[j * row + k]);
    }
    const float4 gg = gv[k];
    ov[k] = make_float4(fold_tail<MEAN>(s.x, gg.x, recip, count, nw),
                        fold_tail<MEAN>(s.y, gg.y, recip, count, nw),
                        fold_tail<MEAN>(s.z, gg.z, recip, count, nw),
                        fold_tail<MEAN>(s.w, gg.w, recip, count, nw));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool MEAN>
int launch_fold(const float* g, const float* d, float* out, long long n,
                int nw, float recip, const float* count, cudaStream_t s) {
  const long long groups =
      aligned16(g) && aligned16(d) && aligned16(out) && n % 4 == 0 ? n / 4
                                                                  : 0;
  const long long n_scalar = n - 4 * groups;
  static int cached[MAX_DEVICES] = {};
  const int blocks = grid_for(
      groups > n_scalar ? groups : n_scalar,
      resident_blocks(reinterpret_cast<const void*>(fold_f32_kernel<MEAN>),
                      cached));
  fold_f32_kernel<MEAN><<<blocks, NTHREADS, 0, s>>>(g, d, out, n, nw, groups,
                                                    recip, count);
  return static_cast<int>(cudaGetLastError());
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

// out [n] = a [na] + b [nb], f32, with XLA's NaN rule, na and nb dividing
// n (the smaller operand repeated over out's leading rows); out may be a
// or b where it has their size.
int nat_add_f32(const void* a, const void* b, void* out, long long n,
                long long na, long long nb, void* stream) {
  const bool bcast = na != n || nb != n;
  const long long groups = aligned16(a) && aligned16(b) && aligned16(out) &&
                                   na % 4 == 0 && nb % 4 == 0
                               ? n / 4
                               : 0;
  const long long vec_threads = (groups + UNROLL - 1) / UNROLL;
  const long long n_scalar = n - 4 * groups;
  const long long threads = vec_threads > n_scalar ? vec_threads : n_scalar;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  if (bcast) {
    static int cached[MAX_DEVICES] = {};
    const int blocks = grid_for(
        threads, resident_blocks(
                     reinterpret_cast<const void*>(add_f32_kernel<true>),
                     cached));
    add_f32_kernel<true><<<blocks, NTHREADS, 0, s>>>(af, bf, of, n, na, nb,
                                                     groups);
  } else {
    static int cached[MAX_DEVICES] = {};
    const int blocks = grid_for(
        threads, resident_blocks(
                     reinterpret_cast<const void*>(add_f32_kernel<false>),
                     cached));
    add_f32_kernel<false><<<blocks, NTHREADS, 0, s>>>(af, bf, of, n, na, nb,
                                                      groups);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [n] = g [n] + (sum_j d [nw, n]) / count, f32, with XLA's NaN rule;
// count a device f32 scalar, or, when count is null, the host's nw-worker
// mean through recip = fl(1/nw). out may be g.
int nat_fold_f32(const void* g, const void* d, void* out, long long n,
                 int nw, float recip, const void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* df = static_cast<const float*>(d);
  float* of = static_cast<float*>(out);
  return count == nullptr
             ? launch_fold<true>(gf, df, of, n, nw, recip, nullptr, s)
             : launch_fold<false>(gf, df, of, n, nw, 0.0f,
                                  static_cast<const float*>(count), s);
}

}  // extern "C"
