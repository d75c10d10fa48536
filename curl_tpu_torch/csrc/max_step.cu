// Fused 2-party comparison (ltz) and max-tournament step for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// curl_tpu/ops/pallas_max_step.py: `_ltz_kernel_call` (:346; math
// `ltz_bit_math` :158; entry fused_ltz_mpc :453) and `_kernel_call` (:223;
// math `max_step_math` :167; entry fused_max_step_mpc :305). Two entry
// points share the device code of the packed 32-bit sign circuit:
//
//   ltz       d -> arithmetic 0/1 shares of d < 0: A2B re-share, one Beaver
//             AND level and five prefix levels of the packed SPK adder, then
//             the multiplication-free B2A of the sign bit
//   max_step  carry, rolled -> rolled + (carry >= rolled) * (carry - rolled):
//             the sign circuit on d = carry - rolled, B2A of NOT ltz, and the
//             Beaver select
//
// One thread owns one packed word for both simulated parties: of n
// elements, element k in the low 32-bit lane and element k + m in the high
// lane (m = ceil(n / 2); a missing k + m reads a zero share and is not
// written). The whole protocol stays in registers; only the result shares
// are written. Operands are read in place through their strides (a
// broadcast `rolled` has stride 0).
//
// Randomness: draw `s` (its slot in the protocol's call order, as the plain
// version kernels/max_step.py numbers them) for word k is
// philox_slot(key, count, s, k) (csrc/philox.cuh); an rbit() slot
// gives bit h of that draw to half h. Nothing depends on the launch
// geometry, so kernel and plain version agree bit for bit.
//
// What bounds it on an H100: a max_step word (two elements) reads 8 shares
// and writes 4 (96 bytes: 0.029 ns at 3.35 TB/s) but needs 71 draws, 35.5
// Philox4x32-10 calls (one call gives two draws), 22 Beaver ANDs and 10
// 64-bit products: about 3,500 32-bit integer operations (0.052 ns at the
// 67 T/s 32-bit rate), so the integer operations bound it (ltz: 61 draws,
// about 3,000 operations). The design draws every protocol random word in
// the thread that uses it, once, and keeps all ~60 intermediate planes of
// the TPU kernel out of memory. It makes one Philox call per draw, twice the
// calls needed, so that the plain version can use kernels/philox.py's
// streams as they are; at the vocab softmax's 3,216,448 elements both entry
// points run at 3.5-3.6x the operations bound (chip_smoke phase 3b;
// PERF.md).

#include "philox.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 256;
constexpr int kLevels = 5;

typedef unsigned long long u64;

__host__ __device__ constexpr u64 level_mask(int i) {
  u64 m = 0;
  for (int s = (1 << i) - 1; s < 64; s += 1 << (i + 1)) m |= 1ull << s;
  return m;
}

__host__ __device__ constexpr u64 level_out_mask(int i) {
  return level_mask(i) * ((1ull << ((1 << i) + 1)) - 2ull);
}

constexpr u64 kBoundaryClear = ~(1ull << 32);

}  // namespace

struct Operand {
  const u64* ptr;           // party 0's share; party 1's at ptr + party
  long long party;
  long long mem[kMaxDims];  // memory stride per dim (0: broadcast)
};

struct StepArgs {
  Operand a, b;             // ltz: a = d; max_step: a = carry, b = rolled
  long long size[kMaxDims];
  int nd;
  long long n;
  u64 key, count;
};

namespace {

struct Rand {
  u64 key, count;
  u64 k;     // word index
  int slot;  // next draw's slot

  __device__ __forceinline__ u64 bits() {
    return philox_slot(key, count, slot++, k);
  }
};

__device__ __forceinline__ long long offset(const StepArgs& a, const long long* mem, long long e) {
  unsigned rem = static_cast<unsigned>(e);
  long long off = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 0; --d) {
    if (d < a.nd) {
      const unsigned sz = static_cast<unsigned>(a.size[d]);
      off += static_cast<long long>(rem % sz) * mem[d];
      rem /= sz;
    }
  }
  return off;
}

// One Beaver AND on XOR shares: z0 ^ z1 = (u0 ^ u1) & (v0 ^ v1).
__device__ __forceinline__ void beaver_and(u64 u0, u64 u1, u64 v0, u64 v1, Rand& R, u64& z0,
                                           u64& z1) {
  const u64 a0 = R.bits(), a1 = R.bits(), b0 = R.bits(), b1 = R.bits(), c0 = R.bits();
  const u64 c1 = ((a0 ^ a1) & (b0 ^ b1)) ^ c0;
  const u64 eps = (u0 ^ a0) ^ (u1 ^ a1);
  const u64 delta = (v0 ^ b0) ^ (v1 ^ b1);
  z0 = c0 ^ (b0 & eps) ^ (u0 & delta);
  z1 = c1 ^ (b1 & eps) ^ (u1 & delta);
}

__device__ __forceinline__ u64 mul_pow2m2(u64 x, int k) { return (x << k) - (x << 1); }

// XOR shares of the packed words' sum bits from each party's packed word;
// bit 31 (63) of sum_p is party p's share of the sign of element k (k + m).
__device__ __forceinline__ void sign_bits(u64 w0p, u64 w1p, Rand& R, u64& sum0, u64& sum1) {
  const u64 x0 = R.bits();
  const u64 x1 = x0 ^ w0p;
  const u64 y1 = R.bits();
  const u64 y0 = y1 ^ w1p;
  u64 s0, s1;
  beaver_and(x0, x1, y0, y1, R, s0, s1);
  const u64 po0 = x0 ^ y0, po1 = x1 ^ y1;
  u64 p0 = po0, p1 = po1;
#pragma unroll
  for (int i = 0; i < kLevels; ++i) {
    const u64 in_mask = level_mask(i), out_mask = level_out_mask(i);
    const int k = (1 << i) + 1;
    const u64 pm0 = p0 & out_mask, pm1 = p1 & out_mask;
    const u64 sf0 = mul_pow2m2(s0 & in_mask, k), sf1 = mul_pow2m2(s1 & in_mask, k);
    const u64 pf0 = mul_pow2m2(p0 & in_mask, k), pf1 = mul_pow2m2(p1 & in_mask, k);
    u64 us0, us1, up0, up1;
    beaver_and(pm0, pm1, sf0, sf1, R, us0, us1);
    beaver_and(pm0, pm1, pf0, pf1, R, up0, up1);
    s0 ^= us0;
    s1 ^= us1;
    p0 = (p0 & ~out_mask) ^ up0;
    p1 = (p1 & ~out_mask) ^ up1;
  }
  sum0 = po0 ^ ((s0 << 1) & kBoundaryClear);
  sum1 = po1 ^ ((s1 << 1) & kBoundaryClear);
}

// B2A of the XOR-shared bits (bit0[h], bit1[h]) of the two halves.
__device__ __forceinline__ void b2a(const u64 bit0[2], const u64 bit1[2], Rand& R, u64 a0[2],
                                    u64 a1[2]) {
  const u64 wrb = R.bits();
  const u64 wrb0 = R.bits();
  u64 ra0[2];
  ra0[0] = R.bits();
  ra0[1] = R.bits();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const u64 rb = (wrb >> h) & 1ull, rb0 = (wrb0 >> h) & 1ull;
    const u64 rb1 = rb ^ rb0;
    const u64 ra1 = rb - ra0[h];
    const u64 t = bit0[h] ^ bit1[h] ^ rb0 ^ rb1;
    a0[h] = t ? 1ull - ra0[h] : ra0[h];
    a1[h] = t ? 0ull - ra1 : ra1;
  }
}

template <bool STEP>
__global__ void __launch_bounds__(kThreads) step_kernel(StepArgs a, u64* __restrict__ out) {
  const long long m = (a.n + 1) >> 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; k < m;
       k += stride) {
    const long long e[2] = {k, k + m};
    const bool has1 = k + m < a.n;
    // d (ltz) or carry and rolled (step), both halves, both parties
    u64 c0[2], c1[2], r0[2] = {0, 0}, r1[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c0[h] = c1[h] = 0;
      if (h == 0 || has1) {
        const long long oa = offset(a, a.a.mem, e[h]);
        c0[h] = a.a.ptr[oa];
        c1[h] = a.a.ptr[a.a.party + oa];
        if (STEP) {
          const long long ob = offset(a, a.b.mem, e[h]);
          r0[h] = a.b.ptr[ob];
          r1[h] = a.b.ptr[a.b.party + ob];
        }
      }
    }
    u64 d0[2], d1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d0[h] = c0[h] - r0[h];
      d1[h] = c1[h] - r1[h];
    }
    Rand R{a.key, a.count, static_cast<u64>(k), 0};
    u64 sum0, sum1;
    sign_bits((d0[0] & 0xFFFFFFFFull) | (d0[1] << 32), (d1[0] & 0xFFFFFFFFull) | (d1[1] << 32),
              R, sum0, sum1);
    u64 bit0[2] = {(sum0 >> 31) & 1ull, sum0 >> 63};
    const u64 bit1[2] = {(sum1 >> 31) & 1ull, sum1 >> 63};
    if (STEP) {  // ge = NOT ltz, flipped on party 0's share
      bit0[0] ^= 1ull;
      bit0[1] ^= 1ull;
    }
    u64 g0[2], g1[2];
    b2a(bit0, bit1, R, g0, g1);
    u64 z0[2], z1[2];
    if (STEP) {  // Beaver select: rolled + ge * d
      u64 a20[2], a21[2], b20[2], b21[2], c20[2];
      a20[0] = R.bits(); a20[1] = R.bits();
      a21[0] = R.bits(); a21[1] = R.bits();
      b20[0] = R.bits(); b20[1] = R.bits();
      b21[0] = R.bits(); b21[1] = R.bits();
      c20[0] = R.bits(); c20[1] = R.bits();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const u64 c21 = (a20[h] + a21[h]) * (b20[h] + b21[h]) - c20[h];
        const u64 eps = (g0[h] - a20[h]) + (g1[h] - a21[h]);
        const u64 delta = (d0[h] - b20[h]) + (d1[h] - b21[h]);
        z0[h] = r0[h] + (c20[h] + eps * b20[h] + delta * g0[h]);
        z1[h] = r1[h] + (c21 + eps * b21[h] + delta * g1[h]);
      }
    } else {
      z0[0] = g0[0]; z0[1] = g0[1];
      z1[0] = g1[0]; z1[1] = g1[1];
    }
    out[e[0]] = z0[0];
    out[a.n + e[0]] = z1[0];
    if (has1) {
      out[e[1]] = z0[1];
      out[a.n + e[1]] = z1[1];
    }
  }
}

template <bool STEP>
int launch(const StepArgs* args, long long* out, void* stream) {
  const StepArgs& a = *args;
  if (a.nd < 0 || a.nd > kMaxDims || a.n < 0 || a.n > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  const long long words = (a.n + 1) >> 1;
  long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  step_kernel<STEP><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, reinterpret_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: the contiguous (2, n) result. Return cudaGetLastError().
extern "C" int ltz_launch(const StepArgs* args, long long* out, void* stream) {
  return launch<false>(args, out, stream);
}

extern "C" int max_step_launch(const StepArgs* args, long long* out, void* stream) {
  return launch<true>(args, out, stream);
}
