// Seed expansion of seed-compressed 2-party shares for Hopper (sm_90a), and
// the Beaver open of a seed-compressed operand.
//
// Replaces the JAX package's Pallas TPU kernel `_get_batched_draw`
// (curl_tpu/ops/pallas_rng.py:43, its pallas_call at :83) where it generates
// party 1's share of every seed-compressed parameter
// (curl_tpu/mpc/primitives/compressed.py:38-52): a seed-compressed sharing of
// an encoding w is (share0 = w - r, r) with r = stream(key), and only share0
// is resident; r is regenerated at every use. The TPU kernel draws r from the
// chip's hardware PRNG, reseeded per 512-row tile from the tensor's seed words
// (pallas_rng.py:57-76). Here stream(key) is element i of kernels/philox.py's
// Philox4x32-10 stream of the tensor's 64-bit key at counter 0: one Philox
// call at counter (j_lo, j_hi, 0, 0) gives elements 2j and 2j + 1, so every
// value is a pure function of (key, i), whatever the launch geometry. The
// counter is fixed at 0 because the per-tensor key is the whole stream
// identity, as with the JAX package's `rbg` expansion (compressed.py:47-51).
//
// Modes of seed_expand_launch, each one pass over the n elements (in and out
// int64, contiguous):
//   0 compress   out[i] = in[i] - stream(key)[i]          (encrypt: share0)
//   1 expand     out[0][i] = in[i], out[1][i] = stream(key)[i]
//                                  (the (2, n) share of both parties)
//   2 expand1    out[i] = in[i] + stream(key)[i]          (one party: the encoding)
// One thread per element pair, a grid-stride loop, no shared memory. What
// bounds them: bytes (compress 16n, expand 24n); a Philox call, 40.5 SASS
// instructions for two elements, is far under the time the card takes to
// move those elements' bytes.
//
// seed_open_launch: the open of the Beaver operand y - b of a matmul whose y
// is seed-compressed, in one pass. The JAX package computes the expansion
// as one value inside a jitted program, which XLA may fuse with the
// subtraction that reads it (there the TPU kernel's draws feed the open
// directly); an eager port that expanded first would write the (2, n)
// expansion, the difference shares and the reveal's copy to device memory.
// For y viewed as stored or transposed in its last two dims and the
// dealer's b shares (2, *y.shape), it writes
//
//     delta[i] = share0[view(i)] + stream(key)[base(view(i))] - b0[i] - b1[i]
//
// (mod 2^64): public, no party axis, contiguous in y's view shape, indexed
// as b is. Party 1's share is drawn in registers; nothing else reaches
// memory. The stream is indexed by the base (stored) layout, never the
// view's, so the values equal those of the expansion it replaces. For a
// transposed view delta is row-major, where the difference it replaces was
// column-major: ring_mm_acc reads the column-major operand a little faster,
// but a tile that transposes b in place of share0 to write it so costs the
// open more than the product gains (PERF.md, PR 7).
//
// What bounds the open: bytes, 32 an element (share0, b0 and b1 read,
// delta written); its Philox work, 40.5 instructions per element pair, is
// about a tenth of that time at the 16.7 T/s integer rate.
//   - untransposed (the embedding's vocab chunks): one element pair a thread
//     (the pair of one Philox call), 16-byte loads and stores where b is
//     contiguous and every pointer 16-byte aligned;
//   - transposed (every linear weight, y = W^T): a block of 256 threads
//     takes a 64 x 64 tile of share0, loaded coalesced along share0's rows
//     (16 bytes a thread where the rows are even), adds the tile's stream
//     words drawn in registers (one Philox call per base element pair; a
//     row that starts at an odd base index takes two calls a thread pair,
//     so that every element keeps its own word), and writes it into shared
//     memory XOR-swizzled by the row (element (s, t) at column t ^ (s & 15)),
//     so that both the 16-byte row-wise stores and the 8-byte column-wise
//     reads of the transposition are free of bank conflicts; then it reads
//     b0 and b1 and writes delta coalesced along b's rows. A thread issues
//     its loads in batches (2 share0 pairs, then 4 elements' b0 and b1)
//     before it uses any of them: a small weight (GPT-2's 768 x 768: 144
//     tiles) is a few blocks an SM, whose loads would otherwise wait one
//     at a time. The batches cost registers, and with them blocks an SM
//     (64 registers: 4 blocks of 256 threads; with batches of 1 and 2, 48
//     registers and 5 blocks): the launch takes, of the two, the one whose
//     last wave of tiles fills more of the card's resident blocks, as the
//     occupancy calculator counts them (GPT-2's 576-tile FFN weights take
//     the smaller batches, GPT-Neo's 1024-tile chunks the larger).

#include <stdint.h>

#include "philox.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kTile = 64;        // view rows (share0's columns) of a transposed tile
constexpr int kTileRows = 64;    // view columns (share0's rows) of a transposed tile
constexpr int kSwizzle = 15;

__device__ __forceinline__ uint4 stream_call(u64 key, u64 j) {
  return philox4x32_10(make_uint4(static_cast<unsigned>(j), static_cast<unsigned>(j >> 32), 0u, 0u),
                       make_uint2(static_cast<unsigned>(key), static_cast<unsigned>(key >> 32)));
}

}  // namespace

template <int MODE>
__global__ void __launch_bounds__(kThreads)
seed_expand_kernel(u64* __restrict__ out, const u64* __restrict__ in, long long n, u64 key) {
  const long long pairs = (n + 1) >> 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < pairs;
       j += stride) {
    const uint4 o = stream_call(key, j);
    const u64 r0 = philox_word(o, false);
    const u64 r1 = philox_word(o, true);
    const long long i0 = 2 * j;
    const bool has1 = i0 + 1 < n;
    const u64 a0 = in[i0];
    const u64 a1 = has1 ? in[i0 + 1] : 0ull;
    if (MODE == 1) {
      out[i0] = a0;
      out[n + i0] = r0;
      if (has1) {
        out[i0 + 1] = a1;
        out[n + i0 + 1] = r1;
      }
    } else {
      out[i0] = MODE == 0 ? a0 - r0 : a0 + r0;
      if (has1) out[i0 + 1] = MODE == 0 ? a1 - r1 : a1 + r1;
    }
  }
}

// The open's operands. y's view is (batches, rows, cols); share0 is stored
// (batches, rows, cols), or (batches, cols, rows) where transposed, and
// contiguous; delta is contiguous in the view's shape; b is read through
// its strides (party 1's share at b + b_party).
struct OpenArgs {
  u64* delta;
  const u64* share0;
  const u64* b;
  long long batches, rows, cols;
  long long b_party, b_batch, b_row, b_col;
  u64 key;
  int dense;  // b's per-party strides are the view's contiguous ones
};

namespace {

__device__ __forceinline__ long long b_offset(const OpenArgs& a, long long i) {
  const long long plane = a.rows * a.cols;
  const long long bt = i / plane;
  const long long rem = i - bt * plane;
  const long long r = rem / a.cols;
  return bt * a.b_batch + r * a.b_row + (rem - r * a.cols) * a.b_col;
}

}  // namespace

// Untransposed: the view is the base layout, so a thread's element pair
// (2j, 2j + 1) is the pair of Philox call j.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) open_flat_kernel(const OpenArgs a) {
  const long long n = a.batches * a.rows * a.cols;
  const long long pairs = (n + 1) >> 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < pairs;
       j += stride) {
    const uint4 o = stream_call(a.key, j);
    const u64 r[2] = {philox_word(o, false), philox_word(o, true)};
    const long long i = 2 * j;
    if (VEC && i + 1 < n) {
      const ulonglong2 s = __ldg(reinterpret_cast<const ulonglong2*>(a.share0 + i));
      const ulonglong2 b0 = __ldg(reinterpret_cast<const ulonglong2*>(a.b + i));
      const ulonglong2 b1 = __ldg(reinterpret_cast<const ulonglong2*>(a.b + a.b_party + i));
      *reinterpret_cast<ulonglong2*>(a.delta + i) =
          make_ulonglong2(s.x + r[0] - b0.x - b1.x, s.y + r[1] - b0.y - b1.y);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (i + e < n) {
        const long long ob = a.dense ? i + e : b_offset(a, i + e);
        a.delta[i + e] = __ldg(a.share0 + i + e) + r[e] - __ldg(a.b + ob) -
                         __ldg(a.b + a.b_party + ob);
      }
    }
  }
}

// Transposed: block (x, y, z) takes view rows [64x, 64x + 64) (share0's
// columns) and view columns [TC y, TC y + TC) (share0's rows) of batch z.
// Each thread issues a batch of its loads before it uses any of them.
template <int TC, int BATCH_IN, int BATCH_OUT>
__global__ void __launch_bounds__(kThreads) open_tile_kernel(const OpenArgs a) {
  constexpr int kWarps = kThreads / 32;        // share0 rows loaded at once, a warp a row
  constexpr int kCols = kThreads / TC;         // delta rows written at once
  static_assert(TC % (kWarps * BATCH_IN) == 0 && kTile % (kCols * BATCH_OUT) == 0,
                "the batches tile the tile");
  __shared__ __align__(16) u64 tile[TC * kTile];
  const long long R = a.rows, C = a.cols;  // the view's; share0 holds (C, R)
  const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long c0 = static_cast<long long>(blockIdx.y) * TC;
  const long long bt = blockIdx.z;
  const long long base = bt * R * C;
  const bool vec = (R & 1) == 0 && (reinterpret_cast<uintptr_t>(a.share0) & 15) == 0;

  // share0's rows c0 + s, columns r0 + 2q and r0 + 2q + 1
  const int q = threadIdx.x & 31;
  const long long r = r0 + 2 * q;
  const bool has1 = r + 1 < R;
  for (int s0 = threadIdx.x >> 5; s0 < TC; s0 += kWarps * BATCH_IN) {
    u64 v0[BATCH_IN], v1[BATCH_IN];
#pragma unroll
    for (int k = 0; k < BATCH_IN; ++k) {
      const long long c = c0 + s0 + k * kWarps;
      const long long p = base + c * R + r;
      v0[k] = v1[k] = 0;
      if (c < C && r < R) {
        if (vec) {
          const ulonglong2 t = __ldg(reinterpret_cast<const ulonglong2*>(a.share0 + p));
          v0[k] = t.x;
          v1[k] = t.y;
        } else {
          v0[k] = __ldg(a.share0 + p);
          if (has1) v1[k] = __ldg(a.share0 + p + 1);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH_IN; ++k) {
      const int s = s0 + k * kWarps;
      const long long p = base + (c0 + s) * R + r;  // base index of the pair's first element
      const uint4 o = stream_call(a.key, static_cast<u64>(p) >> 1);
      if ((p & 1) == 0) {
        v0[k] += philox_word(o, false);
        v1[k] += philox_word(o, true);
      } else {  // the row starts at an odd base index: the pair straddles two calls
        v0[k] += philox_word(o, true);
        if (has1) v1[k] += philox_word(stream_call(a.key, (static_cast<u64>(p) >> 1) + 1), false);
      }
      const int x = s & kSwizzle;
      const int pos = ((2 * q) ^ x) & ~1;
      *reinterpret_cast<ulonglong2*>(tile + s * kTile + pos) =
          (x & 1) ? make_ulonglong2(v1[k], v0[k]) : make_ulonglong2(v0[k], v1[k]);
    }
  }
  __syncthreads();

  // delta's rows r0 + t, columns c0 + u: TC threads along a row
  const int u = threadIdx.x & (TC - 1);
  const long long c = c0 + u;
  if (c >= C) return;
  for (int t0 = threadIdx.x / TC; t0 < kTile; t0 += kCols * BATCH_OUT) {
    u64 b0[BATCH_OUT], b1[BATCH_OUT];
#pragma unroll
    for (int k = 0; k < BATCH_OUT; ++k) {
      const long long rr = r0 + t0 + k * kCols;
      const long long ob = bt * a.b_batch + rr * a.b_row + c * a.b_col;
      b0[k] = b1[k] = 0;
      if (rr < R) {
        b0[k] = __ldg(a.b + ob);
        b1[k] = __ldg(a.b + a.b_party + ob);
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH_OUT; ++k) {
      const int t = t0 + k * kCols;
      if (r0 + t < R) {
        a.delta[(bt * R + r0 + t) * C + c] = tile[u * kTile + (t ^ (u & kSwizzle))] - b0[k] - b1[k];
      }
    }
  }
}

namespace {

long long grid_blocks(long long pairs) {
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  return blocks > 132 * 64 ? 132 * 64 : blocks;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Blocks of a kernel resident on the card at once (SMs x blocks an SM).
template <typename K>
long long resident_blocks(K* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

// The share of its waves' block slots that a grid of `blocks` fills.
double wave_fill(long long blocks, long long slots) {
  const long long waves = (blocks + slots - 1) / slots;
  return static_cast<double>(blocks) / static_cast<double>(waves * slots);
}

}  // namespace

// out: n int64 (modes 0 and 2) or (2, n) int64 (mode 1); in: n int64.
// Returns cudaGetLastError().
extern "C" int seed_expand_launch(long long* out, const long long* in, long long n, u64 key,
                                  int mode, void* stream) {
  if (n < 0 || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = grid_blocks((n + 1) >> 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = reinterpret_cast<u64*>(out);
  auto* a = reinterpret_cast<const u64*>(in);
  switch (mode) {
    case 0: seed_expand_kernel<0><<<blocks, kThreads, 0, st>>>(o, a, n, key); break;
    case 1: seed_expand_kernel<1><<<blocks, kThreads, 0, st>>>(o, a, n, key); break;
    default: seed_expand_kernel<2><<<blocks, kThreads, 0, st>>>(o, a, n, key); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// delta = share0[view] + stream(key)[base] - b0 - b1 over y's view (see
// OpenArgs). Returns cudaGetLastError().
extern "C" int seed_open_launch(const OpenArgs* args, int transposed, void* stream) {
  const OpenArgs& a = *args;
  if (a.batches < 0 || a.rows < 0 || a.cols < 0) return cudaErrorInvalidValue;
  const long long n = a.batches * a.rows * a.cols;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (transposed) {
    const long long gx = (a.rows + kTile - 1) / kTile;
    const long long gy = (a.cols + kTileRows - 1) / kTileRows;
    if (gy > 65535 || a.batches > 65535) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                    static_cast<unsigned>(a.batches));
    // the batched kernel's registers allow 4 blocks an SM, the other's 5:
    // take the one whose last wave of tiles is fuller
    static const long long slots_small = resident_blocks(open_tile_kernel<kTileRows, 1, 2>);
    static const long long slots_batched = resident_blocks(open_tile_kernel<kTileRows, 2, 4>);
    const long long tiles = gx * gy * a.batches;
    if (wave_fill(tiles, slots_small) > wave_fill(tiles, slots_batched)) {
      open_tile_kernel<kTileRows, 1, 2><<<grid, kThreads, 0, st>>>(a);
    } else {
      open_tile_kernel<kTileRows, 2, 4><<<grid, kThreads, 0, st>>>(a);
    }
  } else {
    const long long blocks = grid_blocks((n + 1) >> 1);
    const bool vec = a.dense && aligned16(a.share0) && aligned16(a.b) && aligned16(a.delta) &&
                     (a.b_party & 1) == 0;
    if (vec) {
      open_flat_kernel<true><<<blocks, kThreads, 0, st>>>(a);
    } else {
      open_flat_kernel<false><<<blocks, kThreads, 0, st>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
