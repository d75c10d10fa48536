// Fused 2-party elementwise Beaver multiply / square with its rescale, and
// the EGK truncation alone, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel curl_tpu/ops/pallas_mul.py
// `_kernel_call` (:177; math :92-167; entry points fused_mul_mpc,
// fused_square_mpc, fused_trunc_mpc :362-377). One thread computes one output
// element for both simulated parties, entirely in registers:
//
//   mul     a, b, c = ab drawn and PRZS-shared in the thread; eps = x - a and
//           delta = y - b opened; z_p = c_p + eps b_p + x_p delta
//   square  r, r^2 drawn and shared; eps = x - r; z_p = r2_p + 2 r_p eps
//           (+ eps^2 on party 0)
//   trunc   z = x
//
// then the EGK+20 Fig. 10 probabilistic truncation by 2^m at l = 62 (one
// open of c), the 2-party local truncation of each share, or none. Only the
// two result shares are written. The arithmetic is native 64-bit integer
// arithmetic wrapping mod 2^64 (the TPU kernel emulates it on u32 lo/hi
// planes because Mosaic has no u64); `sar` is the one signed shift.
//
// Randomness: draw `s` (its slot in the protocol's call order, as the plain
// version kernels/fused_mul.py numbers them) at index i is
// philox_slot(key, count, s, i) (csrc/philox.cuh), where i is the
// element's index in the space of what is drawn: Beaver's `a` and its mask
// over x's own elements, `b` and its mask over y's, the rest over the output.
// A broadcast operand is read in place (memory stride 0) and opened at its
// own size. Nothing depends on the launch geometry, so the kernel and its
// plain version agree bit for bit.
//
// What bounds it on an H100: per output element a mul+egk pass reads 4
// shares and writes 2 (48 bytes: 0.014 ns at 3.35 TB/s) and needs 11 draws,
// 5.5 Philox4x32-10 calls (one call gives two draws), and 5 64-bit products:
// about 550 32-bit integer operations (0.008 ns at the 67 T/s 32-bit rate).
// Square and trunc need fewer draws, so the bytes bound every variant
// (chip_smoke.fused_work counts both). The design does the least work it
// can in one pass: every draw is made once, in the thread that uses it, and
// never reaches memory. It does make one Philox call per draw, twice the
// calls the function needs, and leaves half of each unused, so that the
// plain version can use kernels/philox.py's streams as they are; at the
// vocab softmax's 3,216,448 elements the variants run at 1.3-1.9x the bytes
// bound (chip_smoke phase 3b; PERF.md).

#include "philox.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 256;
constexpr int kL = 62;  // EGK ring bits

typedef unsigned long long u64;

}  // namespace

struct Operand {
  const u64* ptr;               // party 0's share; party 1's at ptr + party
  long long party;
  long long mem[kMaxDims];      // memory stride per output dim (0: broadcast)
  long long logical[kMaxDims];  // index-space stride per output dim (0: broadcast)
};

struct FusedMulArgs {
  Operand x, y;
  long long size[kMaxDims];
  int nd, op, trunc, m;
  long long n;
  u64 key, count;
};

namespace {

__device__ __forceinline__ u64 draw(const FusedMulArgs& a, int slot, u64 index) {
  return philox_slot(a.key, a.count, slot, index);
}

__device__ __forceinline__ u64 low_bits(u64 v, int bits) {
  return bits >= 64 ? v : v & ((1ull << bits) - 1ull);
}

__device__ __forceinline__ u64 sar(u64 v, int k) {
  return static_cast<u64>(static_cast<long long>(v) >> k);
}

__device__ __forceinline__ u64 trunc_div_pow2(u64 v, int m) {
  if (m == 0) return v;
  const u64 corr = static_cast<long long>(v) < 0 ? (1ull << m) - 1ull : 0ull;
  return sar(v + corr, m);
}

template <int OP, int TRUNC>
__global__ void __launch_bounds__(kThreads) fused_mul_kernel(FusedMulArgs a, u64* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    // output multi-index -> memory offsets and index-space indices
    unsigned rem = static_cast<unsigned>(i);
    long long xo = 0, yo = 0, xi = 0, yi = 0;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      if (d < a.nd) {
        const unsigned sz = static_cast<unsigned>(a.size[d]);
        const long long c = rem % sz;
        rem /= sz;
        xo += c * a.x.mem[d];
        xi += c * a.x.logical[d];
        if (OP == 0) {
          yo += c * a.y.mem[d];
          yi += c * a.y.logical[d];
        }
      }
    }
    const u64 x0 = a.x.ptr[xo];
    const u64 x1 = a.x.ptr[a.x.party + xo];
    u64 z0, z1;
    int slot = 0;
    if (OP == 0) {  // mul
      const u64 y0 = a.y.ptr[yo];
      const u64 y1 = a.y.ptr[a.y.party + yo];
      const u64 av = draw(a, 0, xi);
      const u64 bv = draw(a, 1, yi);
      const u64 cv = av * bv;
      const u64 sa = draw(a, 2, xi);
      const u64 sb = draw(a, 3, yi);
      const u64 sc = draw(a, 4, i);
      const u64 a0 = sa + av, a1 = 0ull - sa;
      const u64 b0 = sb + bv, b1 = 0ull - sb;
      const u64 c0 = sc + cv, c1 = 0ull - sc;
      const u64 eps = (x0 - a0) + (x1 - a1);
      const u64 delta = (y0 - b0) + (y1 - b1);
      z0 = c0 + eps * b0 + x0 * delta;
      z1 = c1 + eps * b1 + x1 * delta;
      slot = 5;
    } else if (OP == 1) {  // square
      const u64 r = draw(a, 0, i);
      const u64 r2 = r * r;
      const u64 sr = draw(a, 1, i);
      const u64 sr2 = draw(a, 2, i);
      const u64 r0 = sr + r, r1 = 0ull - sr;
      const u64 r20 = sr2 + r2, r21 = 0ull - sr2;
      const u64 eps = (x0 - r0) + (x1 - r1);
      z0 = r20 + (r0 << 1) * eps + eps * eps;
      z1 = r21 + (r1 << 1) * eps;
      slot = 3;
    } else {  // trunc
      z0 = x0;
      z1 = x1;
    }
    if (TRUNC == 1) {  // EGK+20 Fig. 10, l = 62
      const int m = a.m;
      const u64 r = low_bits(draw(a, slot, i), kL - m);
      const u64 s_r = draw(a, slot + 1, i);
      const u64 rp = low_bits(draw(a, slot + 2, i), m);
      const u64 s_rp = draw(a, slot + 3, i);
      const u64 b = draw(a, slot + 4, i) & 1ull;
      const u64 s_b = draw(a, slot + 5, i);
      const u64 r_sh0 = s_r + r, r_sh1 = 0ull - s_r;
      const u64 rp_sh0 = s_rp + rp, rp_sh1 = 0ull - s_rp;
      const u64 b_sh0 = s_b + b, b_sh1 = 0ull - s_b;
      // step 1: mask and open c
      const u64 a0 = z0 + (1ull << (kL - 1));
      const u64 enc0 = (a0 + ((b_sh0 << kL) + ((r_sh0 << m) + rp_sh0))) << (64 - kL - 1);
      const u64 enc1 = (z1 + ((b_sh1 << kL) + ((r_sh1 << m) + rp_sh1))) << (64 - kL - 1);
      const u64 c_p = sar(enc0 + enc1, 64 - kL - 1);
      // step 2: strip the masking bit
      const u64 c_pl = (c_p >> kL) & 1ull;
      const u64 v0 = c_pl ? 1ull - b_sh0 : b_sh0;
      const u64 v1 = c_pl ? 0ull - b_sh1 : b_sh1;
      // step 3: reconstruct the truncation
      const u64 pub_tail = (c_p & ((1ull << kL) - 1ull)) >> m;
      z0 = (v0 << (kL - m)) - r_sh0 + ((0ull - (1ull << (kL - m - 1))) + pub_tail);
      z1 = (v1 << (kL - m)) - r_sh1;
    } else if (TRUNC == 2) {
      z0 = trunc_div_pow2(z0, a.m);
      z1 = trunc_div_pow2(z1, a.m);
    }
    out[i] = z0;
    out[a.n + i] = z1;
  }
}

template <int OP, int TRUNC>
void launch(const FusedMulArgs& a, u64* out, cudaStream_t st) {
  long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fused_mul_kernel<OP, TRUNC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a, out);
}

}  // namespace

// op: 0 mul, 1 square, 2 trunc; trunc: 0 none, 1 egk, 2 crypten. out is the
// contiguous (2, n) result. Returns cudaGetLastError().
extern "C" int fused_mul_launch(const FusedMulArgs* args, long long* out, void* stream) {
  const FusedMulArgs& a = *args;
  if (a.nd < 0 || a.nd > kMaxDims || a.n < 0 || a.n > 0x7FFFFFFFll || a.op < 0 || a.op > 2 ||
      a.trunc < 0 || a.trunc > 2 || a.m < 0 || a.m >= (a.trunc == 1 ? kL : 63) ||
      (a.op == 2 && a.trunc != 1))
    return cudaErrorInvalidValue;
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* o = reinterpret_cast<u64*>(out);
  switch (a.op * 3 + a.trunc) {
    case 0: launch<0, 0>(a, o, st); break;
    case 1: launch<0, 1>(a, o, st); break;
    case 2: launch<0, 2>(a, o, st); break;
    case 3: launch<1, 0>(a, o, st); break;
    case 4: launch<1, 1>(a, o, st); break;
    case 5: launch<1, 2>(a, o, st); break;
    case 7: launch<2, 1>(a, o, st); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
