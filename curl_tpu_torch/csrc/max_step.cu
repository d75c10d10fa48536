// Fused 2-party comparison (ltz) and max-tournament steps for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels in
// curl_tpu/ops/pallas_max_step.py: `_ltz_kernel_call` (:346; math
// `ltz_bit_math` :158; entry fused_ltz_mpc :453) and `_kernel_call` (:223;
// math `max_step_math` :167; entry fused_max_step_mpc :305), and the
// `lax.scan` bodies of curl_tpu/functions/maximum.py that call the latter
// once a step (:324-343, :373-380). One kernel template, three modes:
//
//   ltz        d -> arithmetic 0/1 shares of d < 0: A2B re-share, one Beaver
//              AND level and five prefix levels of the packed SPK adder, then
//              the multiplication-free B2A of the sign bit
//   step/fold  carry, rolled -> rolled + (carry >= rolled) * (carry - rolled):
//              the sign circuit on d = carry - rolled, B2A of NOT ltz, and the
//              Beaver select; `steps` such steps, step g reading the chunk at
//              b + g * b_step with draw count count + g and the carry kept in
//              registers (one step: b_step = 0; scan_reduction's chunk fold:
//              the G - 1 chunks of a (..., G, W) tensor read in place)
//   butterfly  `steps` steps of x -> step(x, roll(x, -(w >> (g + 1)))) over
//              the last dim (w wide): a block holds whole rows in shared
//              memory, rolls there, and writes only the last step's x
//
// Packing: of n elements, element k (low 32-bit lane) and element k + m
// (high lane) share word k, m = ceil(n / 2) over the whole tensor; a
// missing k + m reads a zero share and is not written. A butterfly block
// therefore owns rows rho and rho + R / 2 of the R rows together, which
// needs R even and w even (kernels/max_step.py runs the step kernel once a
// step otherwise).
//
// Randomness: draw `s` (its slot in the protocol's call order, as the plain
// version kernels/max_step.py numbers them) for word k is word k & 1 of
// philox_slot_pair(key, count, s, k >> 1) (csrc/philox.cuh); an rbit()
// slot gives bit h of that draw to half h. Nothing depends on the launch
// geometry, so kernel and plain version agree bit for bit. `key` points at
// the session's `fused` stream in its slot of the session key table
// (kernels/keys.py), which each thread reads once, so a launch captured in
// a CUDA graph draws from the key the table holds at replay.
//
// What bounds it on an H100: a step word (two elements) reads 8 shares and
// writes 4 (96 bytes: 0.029 ns at 3.35 TB/s) but needs 71 draws, 35.5
// Philox4x32-10 calls, and 10 64-bit products: about 1,450 32-bit integer
// instructions (0.087 ns at the 16.7 T/s integer rate), so the integer
// operations bound it (ltz: 61 draws). The Philox calls are 95% of them.
// The design: a word's draws do not depend on its shares, so a block first
// makes the draws of 64 words into shared memory, one call for each (slot,
// word pair) spread over all 128 threads (half the calls a thread-per-word
// design makes, which keeps one word of each call), then 64 threads run
// the words' circuits reading them from there (568 B a word: 36 KB). At
// the attention's 24,576 words that is 384 blocks of 4 warps,
// all 132 SMs busy with up to 4 blocks each (128 and 256 threads a block
// and 2 to 4 blocks an SM were timed at the path's sizes: this was the
// fastest at all but the vocab's 64 x 128 tail). A chain of steps keeps
// its carry in registers (fold) or its rows in shared memory (butterfly),
// so the steps of one scan stage are one launch and the intermediate
// carries never reach device memory.
//
// ltz (61 draws a word, no select) takes another design: one thread per
// word pair (2j, 2j + 1), each slot's one Philox call made in registers
// just before its Beaver AND needs it and serving both words, the two
// words' circuits interleaved for independent work; no shared memory, no
// barrier, every thread in the circuits (ltz_pair_kernel). It was timed
// against PR 6's draw stage widened to all 128 threads in the circuits
// (61 KB of shared memory, 3 blocks an SM) and was faster (PERF.md). A
// contiguous operand (the GELU's difference) skips offset()'s div/mod walk.

#include "philox.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 128;
constexpr int kChunk = 64;  // words whose draws one draw stage makes
constexpr int kLevels = 5;
constexpr int kSlotsStep = 71;
constexpr int kMaxButterflyWidth = 1024;

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
  Operand a, b;             // ltz: a = d; step/fold: a = carry, b = the first rolled
  long long size[kMaxDims];
  int nd, steps;
  long long n, b_step;      // b_step: elements between the chunks of a fold
  u64 count;
  int dense;                // ltz: a is contiguous over its per-party dims
  const u64* key;           // the key's slot in the session key table
};

namespace {

enum Mode { kLtz = 0, kFold = 1, kButterfly = 2 };

// The draws of one word, slot by slot, from a draw stage's [slot][word]
// table of kChunk words.
struct TableDraws {
  const u64* p;  // the word's column of the table
  int slot;

  __device__ __forceinline__ u64 bits() { return p[(slot++) * kChunk]; }
  __device__ __forceinline__ void bits(u64 (&r)[1]) { r[0] = bits(); }
};

// The draws of the word pair (2j, 2j + 1), slot by slot, made where they
// are needed: one Philox call gives both words' draws.
struct PairDraws {
  u64 key, count, j;
  int slot;

  __device__ __forceinline__ void bits(u64 (&r)[2]) {
    const uint4 o = philox_slot_pair(key, count, slot++, j);
    r[0] = philox_word(o, false);
    r[1] = philox_word(o, true);
  }
};

// Slots 0..S-1 of the kChunk words from word k0 (even) into sd[slot][word]:
// one Philox call per (slot, word pair), two calls in flight a thread.
template <int S>
__device__ __forceinline__ void draw_stage(u64* sd, u64 key, u64 count, long long k0) {
  constexpr int kPairs = kChunk / 2;
  constexpr int kItems = S * kPairs;
  const u64 j0 = static_cast<u64>(k0) >> 1;
  for (int i = threadIdx.x; i < kItems; i += 2 * kThreads) {
    const int i2 = min(i + kThreads, kItems - 1);
    const uint4 o1 = philox_slot_pair(key, count, i / kPairs, j0 + i % kPairs);
    const uint4 o2 = philox_slot_pair(key, count, i2 / kPairs, j0 + i2 % kPairs);
    reinterpret_cast<ulonglong2*>(sd)[i] = make_ulonglong2(philox_word(o1, false),
                                                           philox_word(o1, true));
    reinterpret_cast<ulonglong2*>(sd)[i2] = make_ulonglong2(philox_word(o2, false),
                                                            philox_word(o2, true));
  }
}

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

// The circuits below run on W words at once (their draws from one source),
// each word's operations independent of the others'.

// One Beaver AND on XOR shares: z0 ^ z1 = (u0 ^ u1) & (v0 ^ v1).
template <int W, class D>
__device__ __forceinline__ void beaver_and(const u64 (&u0)[W], const u64 (&u1)[W],
                                           const u64 (&v0)[W], const u64 (&v1)[W], D& R,
                                           u64 (&z0)[W], u64 (&z1)[W]) {
  u64 a0[W], a1[W], b0[W], b1[W], c0[W];
  R.bits(a0);
  R.bits(a1);
  R.bits(b0);
  R.bits(b1);
  R.bits(c0);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const u64 c1 = ((a0[w] ^ a1[w]) & (b0[w] ^ b1[w])) ^ c0[w];
    const u64 eps = (u0[w] ^ a0[w]) ^ (u1[w] ^ a1[w]);
    const u64 delta = (v0[w] ^ b0[w]) ^ (v1[w] ^ b1[w]);
    z0[w] = c0[w] ^ (b0[w] & eps) ^ (u0[w] & delta);
    z1[w] = c1 ^ (b1[w] & eps) ^ (u1[w] & delta);
  }
}

__device__ __forceinline__ u64 mul_pow2m2(u64 x, int k) { return (x << k) - (x << 1); }

// XOR shares of the packed words' sum bits from each party's packed word;
// bit 31 (63) of sum_p is party p's share of the sign of element k (k + m).
template <int W, class D>
__device__ __forceinline__ void sign_bits(const u64 (&w0p)[W], const u64 (&w1p)[W], D& R,
                                          u64 (&sum0)[W], u64 (&sum1)[W]) {
  u64 x0[W], x1[W], y0[W], y1[W];
  R.bits(x0);
  R.bits(y1);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    x1[w] = x0[w] ^ w0p[w];
    y0[w] = y1[w] ^ w1p[w];
  }
  u64 s0[W], s1[W], po0[W], po1[W], p0[W], p1[W];
  beaver_and<W>(x0, x1, y0, y1, R, s0, s1);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    po0[w] = p0[w] = x0[w] ^ y0[w];
    po1[w] = p1[w] = x1[w] ^ y1[w];
  }
#pragma unroll
  for (int i = 0; i < kLevels; ++i) {
    const u64 in_mask = level_mask(i), out_mask = level_out_mask(i);
    const int k = (1 << i) + 1;
    u64 pm0[W], pm1[W], sf0[W], sf1[W], pf0[W], pf1[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      pm0[w] = p0[w] & out_mask;
      pm1[w] = p1[w] & out_mask;
      sf0[w] = mul_pow2m2(s0[w] & in_mask, k);
      sf1[w] = mul_pow2m2(s1[w] & in_mask, k);
      pf0[w] = mul_pow2m2(p0[w] & in_mask, k);
      pf1[w] = mul_pow2m2(p1[w] & in_mask, k);
    }
    u64 us0[W], us1[W], up0[W], up1[W];
    beaver_and<W>(pm0, pm1, sf0, sf1, R, us0, us1);
    beaver_and<W>(pm0, pm1, pf0, pf1, R, up0, up1);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      s0[w] ^= us0[w];
      s1[w] ^= us1[w];
      p0[w] = (p0[w] & ~out_mask) ^ up0[w];
      p1[w] = (p1[w] & ~out_mask) ^ up1[w];
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    sum0[w] = po0[w] ^ ((s0[w] << 1) & kBoundaryClear);
    sum1[w] = po1[w] ^ ((s1[w] << 1) & kBoundaryClear);
  }
}

// B2A of the XOR-shared bits (bit0[w][h], bit1[w][h]) of the two halves.
template <int W, class D>
__device__ __forceinline__ void b2a(const u64 (&bit0)[W][2], const u64 (&bit1)[W][2], D& R,
                                    u64 (&a0)[W][2], u64 (&a1)[W][2]) {
  u64 wrb[W], wrb0[W], ra0[2][W];
  R.bits(wrb);
  R.bits(wrb0);
  R.bits(ra0[0]);
  R.bits(ra0[1]);
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const u64 rb = (wrb[w] >> h) & 1ull, rb0 = (wrb0[w] >> h) & 1ull;
      const u64 rb1 = rb ^ rb0;
      const u64 ra1 = rb - ra0[h][w];
      const u64 t = bit0[w][h] ^ bit1[w][h] ^ rb0 ^ rb1;
      a0[w][h] = t ? 1ull - ra0[h][w] : ra0[h][w];
      a1[w][h] = t ? 0ull - ra1 : ra1;
    }
  }
}

// Arithmetic 0/1 shares z of d < 0 (STEP false), or of d >= 0 (STEP
// true: the tournament step's ge, flipped on party 0's share), for W words
// of each party's two halves.
template <bool STEP, int W, class D>
__device__ __forceinline__ void sign_circuit(const u64 (&d0)[W][2], const u64 (&d1)[W][2], D& R,
                                             u64 (&z0)[W][2], u64 (&z1)[W][2]) {
  u64 w0p[W], w1p[W], sum0[W], sum1[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    w0p[w] = (d0[w][0] & 0xFFFFFFFFull) | (d0[w][1] << 32);
    w1p[w] = (d1[w][0] & 0xFFFFFFFFull) | (d1[w][1] << 32);
  }
  sign_bits<W>(w0p, w1p, R, sum0, sum1);
  u64 bit0[W][2], bit1[W][2];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    bit0[w][0] = ((sum0[w] >> 31) & 1ull) ^ (STEP ? 1ull : 0ull);
    bit0[w][1] = (sum0[w] >> 63) ^ (STEP ? 1ull : 0ull);
    bit1[w][0] = (sum1[w] >> 31) & 1ull;
    bit1[w][1] = sum1[w] >> 63;
  }
  b2a<W>(bit0, bit1, R, z0, z1);
}

// One word's protocol: ltz of c (STEP false), or the tournament step of
// carry c against rolled r (STEP true); both halves, both parties.
template <bool STEP, class D>
__device__ __forceinline__ void word_circuit(const u64 c0[2], const u64 c1[2], const u64 r0[2],
                                             const u64 r1[2], D R, u64 z0[2], u64 z1[2]) {
  u64 d0[1][2], d1[1][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d0[0][h] = c0[h] - r0[h];
    d1[0][h] = c1[h] - r1[h];
  }
  u64 g0[1][2], g1[1][2];
  sign_circuit<STEP, 1>(d0, d1, R, g0, g1);
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
      const u64 eps = (g0[0][h] - a20[h]) + (g1[0][h] - a21[h]);
      const u64 delta = (d0[0][h] - b20[h]) + (d1[0][h] - b21[h]);
      z0[h] = r0[h] + (c20[h] + eps * b20[h] + delta * g0[0][h]);
      z1[h] = r1[h] + (c21 + eps * b21[h] + delta * g1[0][h]);
    }
  } else {
    z0[0] = g0[0][0]; z0[1] = g0[0][1];
    z1[0] = g1[0][0]; z1[1] = g1[0][1];
  }
}

// step/fold: a block owns the kChunk words from blockIdx.x * kChunk.
__device__ __forceinline__ void words_body(const StepArgs& a, u64* __restrict__ out, u64* sd) {
  const long long m = (a.n + 1) >> 1;
  const long long k0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long k = k0 + threadIdx.x;
  const bool live = threadIdx.x < kChunk && k < m;
  const long long e[2] = {k, k + m};
  const bool has1 = live && k + m < a.n;
  const u64 key = *a.key;
  u64 c0[2] = {0, 0}, c1[2] = {0, 0}, r0[2] = {0, 0}, r1[2] = {0, 0};
  long long ob[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 0 ? live : has1) {
      const long long oa = offset(a, a.a.mem, e[h]);
      c0[h] = a.a.ptr[oa];
      c1[h] = a.a.ptr[a.a.party + oa];
      ob[h] = offset(a, a.b.mem, e[h]);
    }
  }
  for (int g = 0; g < a.steps; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 0 ? live : has1) {
        const long long o = ob[h] + g * a.b_step;
        r0[h] = a.b.ptr[o];
        r1[h] = a.b.ptr[a.b.party + o];
      }
    }
    if (g > 0) __syncthreads();  // the previous step's circuits have read the table
    draw_stage<kSlotsStep>(sd, key, a.count + g, k0);
    __syncthreads();
    if (live) {
      u64 z0[2], z1[2];
      word_circuit<true>(c0, c1, r0, r1, TableDraws{sd + threadIdx.x, 0}, z0, z1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        c0[h] = z0[h];
        c1[h] = z1[h];
      }
    }
  }
  if (live) {
    out[e[0]] = c0[0];
    out[a.n + e[0]] = c1[0];
    if (has1) {
      out[e[1]] = c0[1];
      out[a.n + e[1]] = c1[1];
    }
  }
}

// ltz, one thread per word pair (2j, 2j + 1): each slot's one Philox call,
// made in registers just before the circuit needs it, gives both words'
// draws; the two words' circuits run interleaved. No shared memory, no
// barrier: every thread runs circuits.
__global__ void __launch_bounds__(kThreads, 4) ltz_pair_kernel(StepArgs a,
                                                               u64* __restrict__ out) {
  const long long m = (a.n + 1) >> 1;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (2 * j >= m) return;
  long long e[2][2];
  bool has[2][2];
  u64 d0[2][2], d1[2][2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long k = 2 * j + w;
      e[w][h] = k + h * m;
      has[w][h] = k < m && e[w][h] < a.n;
      d0[w][h] = d1[w][h] = 0;
      if (has[w][h]) {
        const long long o = a.dense ? e[w][h] : offset(a, a.a.mem, e[w][h]);
        d0[w][h] = a.a.ptr[o];
        d1[w][h] = a.a.ptr[a.a.party + o];
      }
    }
  }
  PairDraws R{*a.key, a.count, static_cast<u64>(j), 0};
  u64 z0[2][2], z1[2][2];
  sign_circuit<false, 2>(d0, d1, R, z0, z1);
#pragma unroll
  for (int w = 0; w < 2; ++w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (has[w][h]) {
        out[e[w][h]] = z0[w][h];
        out[a.n + e[w][h]] = z1[w][h];
      }
    }
  }
}

// butterfly: a block owns rows [rho0, rho0 + P) and the same rows + R / 2,
// whole, in xs[buffer][party][half][word]; the kChunk words of a draw
// stage at a time.
__device__ __forceinline__ void butterfly_body(const StepArgs& a, u64* __restrict__ out, u64* sd,
                                               u64* xs) {
  const int w = static_cast<int>(a.size[a.nd - 1]);
  const long long half = a.n / w / 2;  // R / 2 rows
  const long long m = half * w;
  const int P = w >= kChunk ? 1 : kChunk / w;
  const long long rho0 = static_cast<long long>(blockIdx.x) * P;
  const int words = static_cast<int>(min(static_cast<long long>(P), half - rho0)) * w;
  const int W = P * w;
  const long long k0 = rho0 * w;
  const u64 key = *a.key;
  auto at = [&](int buf, int party, int h, int q) -> u64& {
    return xs[((buf * 2 + party) * 2 + h) * W + q];
  };
  for (int q = threadIdx.x; q < words; q += kThreads) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long o = offset(a, a.a.mem, k0 + q + h * m);
      at(0, 0, h, q) = a.a.ptr[o];
      at(0, 1, h, q) = a.a.ptr[a.a.party + o];
    }
  }
  int buf = 0;
  for (int g = 0; g < a.steps; ++g) {
    const int shift = w >> (g + 1);
    for (int q0 = 0; q0 < words; q0 += kChunk) {
      // the previous chunk's circuits have read the table, and the loads
      // (g = 0) or the previous step's writes are in
      __syncthreads();
      draw_stage<kSlotsStep>(sd, key, a.count + g, k0 + q0);
      __syncthreads();
      const int q = q0 + static_cast<int>(threadIdx.x);
      if (threadIdx.x < kChunk && q < words) {
        const int row = q / w, col = q - row * w;
        const int qr = row * w + (col + shift) % w;
        u64 c0[2], c1[2], r0[2], r1[2], z0[2], z1[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          c0[h] = at(buf, 0, h, q);
          c1[h] = at(buf, 1, h, q);
          r0[h] = at(buf, 0, h, qr);
          r1[h] = at(buf, 1, h, qr);
        }
        word_circuit<true>(c0, c1, r0, r1, TableDraws{sd + threadIdx.x, 0}, z0, z1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          at(buf ^ 1, 0, h, q) = z0[h];
          at(buf ^ 1, 1, h, q) = z1[h];
        }
      }
    }
    buf ^= 1;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < words; q += kThreads) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long e = k0 + q + h * m;
      out[e] = at(buf, 0, h, q);
      out[a.n + e] = at(buf, 1, h, q);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 4) step_kernel(StepArgs a, u64* __restrict__ out) {
  extern __shared__ __align__(16) u64 smem[];
  if (MODE == kButterfly) {
    butterfly_body(a, out, smem, smem + kSlotsStep * kChunk);
  } else {
    words_body(a, out, smem);
  }
}

int check_args(const StepArgs& a, int mode) {
  if (a.nd < (mode == kButterfly ? 1 : 0) || a.nd > kMaxDims || a.n < 0 || a.n > 0x7FFFFFFFll ||
      a.steps < 1 || (mode == kLtz && a.steps != 1) || a.key == nullptr)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int MODE>
int launch(const StepArgs* args, long long* out, void* stream) {
  const StepArgs& a = *args;
  if (check_args(a, MODE) != cudaSuccess) return cudaErrorInvalidValue;
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  long long blocks;
  size_t smem = static_cast<size_t>(kSlotsStep) * kChunk * 8;
  if (MODE == kButterfly) {
    const long long w = a.size[a.nd - 1];
    const long long rows = a.n / w;
    if (w < 2 || (w & 1) || w > kMaxButterflyWidth || (rows & 1)) return cudaErrorInvalidValue;
    const long long P = w >= kChunk ? 1 : kChunk / w;
    blocks = (rows / 2 + P - 1) / P;
    smem += static_cast<size_t>(P * w) * 8 * 8;  // two buffers x two parties x two halves
    static size_t allowed = 48 * 1024;
    if (smem > allowed) {
      const cudaError_t rc = cudaFuncSetAttribute(
          step_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
      allowed = smem;
    }
  } else {
    blocks = ((a.n + 1) / 2 + kChunk - 1) / kChunk;
  }
  step_kernel<MODE><<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, reinterpret_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

int launch_ltz_pairs(const StepArgs* args, long long* out, void* stream) {
  const StepArgs& a = *args;
  if (check_args(a, kLtz) != cudaSuccess) return cudaErrorInvalidValue;
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  const long long pairs = ((a.n + 1) / 2 + 1) / 2;
  ltz_pair_kernel<<<static_cast<unsigned>((pairs + kThreads - 1) / kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, reinterpret_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: the contiguous (2, n) result (for a fold: n = the carry's
// elements). Return cudaGetLastError().
extern "C" int ltz_launch(const StepArgs* args, long long* out, void* stream) {
  return launch_ltz_pairs(args, out, stream);
}

extern "C" int max_step_launch(const StepArgs* args, long long* out, void* stream) {
  return launch<kFold>(args, out, stream);
}

extern "C" int butterfly_launch(const StepArgs* args, long long* out, void* stream) {
  return launch<kButterfly>(args, out, stream);
}
