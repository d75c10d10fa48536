// Fused 2-party elementwise Beaver multiply / square with its rescale, the
// EGK truncation alone, and a chain of squarings, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel curl_tpu/ops/pallas_mul.py
// `_kernel_call` (:177; math :92-167; entry points fused_mul_mpc,
// fused_square_mpc, fused_trunc_mpc :362-377), and the traced loop of
// squarings that calls it in exp (curl_tpu/functions/approximations.py).
// One thread computes two neighbouring output elements for both simulated
// parties, entirely in registers:
//
//   mul     a, b, c = ab drawn and PRZS-shared in the thread; eps = x - a and
//           delta = y - b opened; z_p = c_p + eps b_p + x_p delta
//   square  r, r^2 drawn and shared; eps = x - r; z_p = r2_p + 2 r_p eps
//           (+ eps^2 on party 0)
//   trunc   z = x
//
// then the EGK+20 Fig. 10 probabilistic truncation by 2^m at l = 62 (one
// open of c), the 2-party local truncation of each share, or none. A chain
// (`steps` > 1, square only) feeds each step's result to the next in
// registers, step s at draw count count + s, and writes only the last. The
// arithmetic is native 64-bit integer arithmetic wrapping mod 2^64 (the TPU
// kernel emulates it on u32 lo/hi planes because Mosaic has no u64); `sar`
// is the one signed shift.
//
// Randomness: draw `s` (its slot in the protocol's call order, as the plain
// version kernels/fused_mul.py numbers them) at index i is word i & 1 of
// philox_slot_pair(key, count, s, i >> 1) (csrc/philox.cuh), where i is
// the element's index in the space of what is drawn: Beaver's `a` and its
// mask over x's own elements, `b` and its mask over y's, the rest over the
// output. A broadcast operand is read in place (memory stride 0) and opened
// at its own size. Nothing depends on the launch geometry, so the kernel
// and its plain version agree bit for bit. `key` points at the session's
// `fused` stream in its slot of the session key table (kernels/keys.py),
// which a thread reads once, so a launch captured in a CUDA graph draws
// from the key the table holds at replay.
//
// What bounds it on an H100: per output element a mul+egk pass reads 4
// shares and writes 2 (48 bytes: 0.014 ns at 3.35 TB/s) and needs 11 draws,
// 5.5 Philox4x32-10 calls (one call gives two draws) and 5 64-bit products:
// about 240 SASS integer instructions (0.014 ns at the 16.7 T/s integer
// rate), so the two bounds meet; one squaring of a chain reads and writes
// nothing and needs 1.5 calls and 4 products, so a chain of 8 is bound by
// its operations. The design makes every draw once, in the thread that
// uses it: a thread owns the element pair 2j, 2j + 1 and makes one Philox
// call per draw over the output (both words used), and one over x or y
// where both elements' indices fall into one call (contiguous, or broadcast
// along the pair), two where they do not. Where an operand is contiguous
// over the output it skips the index walk and moves each party's share of
// the pair as one 16-byte load; the result is stored the same way. exp's
// eight squarings are one launch, so the intermediate shares never reach
// device memory.

#include "philox.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 128;
constexpr int kL = 62;  // EGK ring bits

typedef unsigned long long u64;

}  // namespace

struct Operand {
  const u64* ptr;               // party 0's share; party 1's at ptr + party
  long long party;
  long long mem[kMaxDims];      // memory stride per output dim (0: broadcast)
  long long logical[kMaxDims];  // index-space stride per output dim (0: broadcast)
  int dense;                    // element i at ptr[i] and index i; 16-byte aligned pairs
};

struct FusedMulArgs {
  Operand x, y;
  long long size[kMaxDims];
  int nd, op, trunc, m, steps;
  long long n;
  u64 count;
  const u64* key;  // the key's slot in the session key table
};

namespace {

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

// Both parties' shares of output elements i0 and i0 + 1 (the second is
// element i0 again past the end), and their indices in the operand's own
// index space.
__device__ __forceinline__ void load_pair(const FusedMulArgs& a, const Operand& op, long long i0,
                                          bool has1, u64 v0[2], u64 v1[2], long long idx[2]) {
  if (op.dense) {
    idx[0] = i0;
    idx[1] = has1 ? i0 + 1 : i0;
    if (has1) {
      const ulonglong2 p0 = *reinterpret_cast<const ulonglong2*>(op.ptr + i0);
      const ulonglong2 p1 = *reinterpret_cast<const ulonglong2*>(op.ptr + op.party + i0);
      v0[0] = p0.x; v0[1] = p0.y;
      v1[0] = p1.x; v1[1] = p1.y;
    } else {
      v0[0] = v0[1] = op.ptr[i0];
      v1[0] = v1[1] = op.ptr[op.party + i0];
    }
    return;
  }
  // element i0's offsets by the walk over the dims; i0 + 1's from them
  // where it lies in the same row, by the walk where it starts the next
  long long off[2] = {0, 0}, li[2] = {0, 0};
  long long last = 0;  // i0's index in the last dim
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && (!has1 || (a.nd > 0 && last + 1 < a.size[a.nd - 1]))) {
      const bool step = has1 && a.nd > 0;
      off[1] = off[0] + (step ? op.mem[a.nd - 1] : 0);
      li[1] = li[0] + (step ? op.logical[a.nd - 1] : 0);
      break;
    }
    unsigned rem = static_cast<unsigned>(i0 + h);
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      if (d < a.nd) {
        const unsigned sz = static_cast<unsigned>(a.size[d]);
        const long long c = rem % sz;
        rem /= sz;
        if (d == a.nd - 1 && h == 0) last = c;
        off[h] += c * op.mem[d];
        li[h] += c * op.logical[d];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v0[h] = op.ptr[off[h]];
    v1[h] = op.ptr[op.party + off[h]];
    idx[h] = li[h];
  }
}

// Draw `slot` at the pair's own indices idx[0], idx[1] (x's or y's space):
// one Philox call where both fall into it, two where they do not.
__device__ __forceinline__ void draw_at(u64 key, u64 count, int slot, const long long idx[2],
                                        u64 d[2]) {
  const u64 j0 = static_cast<u64>(idx[0]) >> 1, j1 = static_cast<u64>(idx[1]) >> 1;
  const uint4 o = philox_slot_pair(key, count, slot, j0);
  d[0] = philox_word(o, idx[0] & 1);
  d[1] = philox_word(j1 == j0 ? o : philox_slot_pair(key, count, slot, j1), idx[1] & 1);
}

// Draw `slot` over the output: one Philox call, both words.
__device__ __forceinline__ void draw_out(u64 key, u64 count, int slot, u64 j, u64 d[2]) {
  const uint4 o = philox_slot_pair(key, count, slot, j);
  d[0] = philox_word(o, false);
  d[1] = philox_word(o, true);
}

template <int OP, int TRUNC>
__global__ void __launch_bounds__(kThreads) fused_mul_kernel(FusedMulArgs a, u64* __restrict__ out) {
  const long long pairs = (a.n + 1) >> 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const u64 key = *a.key;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < pairs;
       j += stride) {
    const long long i0 = 2 * j;
    const bool has1 = i0 + 1 < a.n;
    u64 x0[2], x1[2], y0[2], y1[2];
    long long xi[2], yi[2];
    load_pair(a, a.x, i0, has1, x0, x1, xi);
    if (OP == 0) load_pair(a, a.y, i0, has1, y0, y1, yi);
    for (int st = 0; st < a.steps; ++st) {
      const u64 count = a.count + st;
      u64 z0[2], z1[2];
      int slot = 0;
      if (OP == 0) {  // mul
        u64 av[2], bv[2], sa[2], sb[2], sc[2];
        draw_at(key, count, 0, xi, av);
        draw_at(key, count, 1, yi, bv);
        draw_at(key, count, 2, xi, sa);
        draw_at(key, count, 3, yi, sb);
        draw_out(key, count, 4, j, sc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const u64 cv = av[h] * bv[h];
          const u64 a0 = sa[h] + av[h], a1 = 0ull - sa[h];
          const u64 b0 = sb[h] + bv[h], b1 = 0ull - sb[h];
          const u64 c0 = sc[h] + cv, c1 = 0ull - sc[h];
          const u64 eps = (x0[h] - a0) + (x1[h] - a1);
          const u64 delta = (y0[h] - b0) + (y1[h] - b1);
          z0[h] = c0 + eps * b0 + x0[h] * delta;
          z1[h] = c1 + eps * b1 + x1[h] * delta;
        }
        slot = 5;
      } else if (OP == 1) {  // square
        u64 r[2], sr[2], sr2[2];
        draw_out(key, count, 0, j, r);
        draw_out(key, count, 1, j, sr);
        draw_out(key, count, 2, j, sr2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const u64 r2 = r[h] * r[h];
          const u64 r0 = sr[h] + r[h], r1 = 0ull - sr[h];
          const u64 r20 = sr2[h] + r2, r21 = 0ull - sr2[h];
          const u64 eps = (x0[h] - r0) + (x1[h] - r1);
          z0[h] = r20 + (r0 << 1) * eps + eps * eps;
          z1[h] = r21 + (r1 << 1) * eps;
        }
        slot = 3;
      } else {  // trunc
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          z0[h] = x0[h];
          z1[h] = x1[h];
        }
      }
      if (TRUNC == 1) {  // EGK+20 Fig. 10, l = 62
        const int m = a.m;
        u64 r[2], s_r[2], rp[2], s_rp[2], b[2], s_b[2];
        draw_out(key, count, slot, j, r);
        draw_out(key, count, slot + 1, j, s_r);
        draw_out(key, count, slot + 2, j, rp);
        draw_out(key, count, slot + 3, j, s_rp);
        draw_out(key, count, slot + 4, j, b);
        draw_out(key, count, slot + 5, j, s_b);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const u64 r_sh0 = s_r[h] + low_bits(r[h], kL - m), r_sh1 = 0ull - s_r[h];
          const u64 rp_sh0 = s_rp[h] + low_bits(rp[h], m), rp_sh1 = 0ull - s_rp[h];
          const u64 b_sh0 = s_b[h] + (b[h] & 1ull), b_sh1 = 0ull - s_b[h];
          // step 1: mask and open c
          const u64 a0 = z0[h] + (1ull << (kL - 1));
          const u64 enc0 = (a0 + ((b_sh0 << kL) + ((r_sh0 << m) + rp_sh0))) << (64 - kL - 1);
          const u64 enc1 = (z1[h] + ((b_sh1 << kL) + ((r_sh1 << m) + rp_sh1))) << (64 - kL - 1);
          const u64 c_p = sar(enc0 + enc1, 64 - kL - 1);
          // step 2: strip the masking bit
          const u64 c_pl = (c_p >> kL) & 1ull;
          const u64 v0 = c_pl ? 1ull - b_sh0 : b_sh0;
          const u64 v1 = c_pl ? 0ull - b_sh1 : b_sh1;
          // step 3: reconstruct the truncation
          const u64 pub_tail = (c_p & ((1ull << kL) - 1ull)) >> m;
          z0[h] = (v0 << (kL - m)) - r_sh0 + ((0ull - (1ull << (kL - m - 1))) + pub_tail);
          z1[h] = (v1 << (kL - m)) - r_sh1;
        }
      } else if (TRUNC == 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          z0[h] = trunc_div_pow2(z0[h], a.m);
          z1[h] = trunc_div_pow2(z1[h], a.m);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x0[h] = z0[h];
        x1[h] = z1[h];
      }
    }
    // the contiguous (2, n) result: party 1's row starts at n, 16-byte
    // aligned where n is even
    if (has1) {
      *reinterpret_cast<ulonglong2*>(out + i0) = make_ulonglong2(x0[0], x0[1]);
      if ((a.n & 1) == 0) {
        *reinterpret_cast<ulonglong2*>(out + a.n + i0) = make_ulonglong2(x1[0], x1[1]);
      } else {
        out[a.n + i0] = x1[0];
        out[a.n + i0 + 1] = x1[1];
      }
    } else {
      out[i0] = x0[0];
      out[a.n + i0] = x1[0];
    }
  }
}

template <int OP, int TRUNC>
void launch(const FusedMulArgs& a, u64* out, cudaStream_t st) {
  long long blocks = ((a.n + 1) / 2 + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fused_mul_kernel<OP, TRUNC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a, out);
}

}  // namespace

// op: 0 mul, 1 square, 2 trunc; trunc: 0 none, 1 egk, 2 crypten; steps:
// 1, or a chain of squarings. out is the contiguous (2, n) result, 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int fused_mul_launch(const FusedMulArgs* args, long long* out, void* stream) {
  const FusedMulArgs& a = *args;
  if (a.nd < 0 || a.nd > kMaxDims || a.n < 0 || a.n > 0x7FFFFFFFll || a.op < 0 || a.op > 2 ||
      a.trunc < 0 || a.trunc > 2 || a.m < 0 || a.m >= (a.trunc == 1 ? kL : 63) ||
      (a.op == 2 && a.trunc != 1) || a.steps < 1 || (a.steps > 1 && a.op != 1) ||
      a.key == nullptr || (reinterpret_cast<unsigned long long>(out) & 15))
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
