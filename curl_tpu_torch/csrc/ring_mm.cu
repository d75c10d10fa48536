// Exact ring matmul mod 2^64 for Hopper (sm_90a): out[g] = sum_p A_p[g] @ B_p[g],
// contracted on the int8 tensor cores with wgmma.
//
// Replaces the JAX package's two Pallas TPU kernels in
// curl_tpu/ops/pallas_ring_mm.py: `_kernel` (:149, one product, reached via
// ring.matmul) and `_acc_kernel` (:324, the multi-pair Beaver reconstruction
// sum, reached via ring.matmul_acc).
//
// Arithmetic (the reference's, pallas_ring_mm.py:57-130): each int64 element
// is x = sum_i d_i 2^(8i) mod 2^64 with balanced digits d_i in [-128, 127].
// They are the bytes of (x + 0x80..80) ^ 0x80..80 read as int8: adding 128
// to every byte makes each digit d_i + 128 a plain byte, with the carries
// the byte + carry recoding of ring._balanced_limbs propagates. Only the 36
// plane pairs with i + j <= 7 survive mod 2^64 (the triangle trim of
// acc_tile_into, :107), and they are summed per diagonal s = i + j into 8
// int32 accumulators, recombined as out += (int64) acc_s << 8s. A digit
// product is at most 2^14 in magnitude and a diagonal sums at most 8 of them
// per k, so a block contracts at most kMaxFlushK = 8192 summed k (over all
// its pairs) before its accumulators are folded: 8 * 8192 * 2^14 = 2^30.
// The wrapper's split (kernels/ring_mm.py, FLUSH_K) gives every block at
// most that many, and the launch refuses more: the fold is the block's
// epilogue, and nothing relies on the int32 result wrapping.
//
// What bounds it: 36 int8 plane products of 2 operations per ring
// multiply-accumulate at 1,979 TOPS, or the operands' bytes at 3.35 TB/s;
// at the path's 64-row products the two are within 2x of each other. The
// int64 operands are 8 times the bytes of one limb plane, and every block
// stages and splits its own tiles, so three jobs of about equal cost share
// a step: the copies (bound by device memory), the split (by shared memory
// and integer issue) and the products (by the tensor cores). Done by the
// same warps one after the other they add up; here each has warps of its
// own, and they overlap (kernels/ring_mm_breakdown.py times each alone).
//
// Design: a block computes a 64 x 64 output tile over a chunk of the summed
// k, 32 k per step, with four warpgroups of their own roles:
//  - loader: each thread copies 16 + 16 int64 elements of a step's tiles
//    with cp.async (8 bytes each, zero-filled past an edge) into a 3-stage
//    ring of shared-memory tiles laid out [row][k] (B as [n][k]),
//    consecutive threads along whichever axis of the operand has unit
//    stride; an mbarrier per stage tracks the copies. Operands are read in
//    place through their strides: broadcast batch slices (stride 0),
//    Linear's column-major weight.t(), attention's permuted keys, the
//    embedding's strided one-hot; addresses advance by adds, and an
//    operand's base is set up once per pair.
//  - splitter: turns a staged step into its 8 + 8 limb planes (two 64-bit
//    ops and 8 byte permutes per 4 elements), K-major in the no-swizzle
//    core-matrix layout the wgmma descriptors name, in one of two plane
//    buffers. No plane reaches device memory.
//  - two product warpgroups: each fetches its A fragments of the 8 planes
//    with ldmatrix and issues wgmma.m64n64k32.s32.s8.s8 (A from registers, B
//    from shared memory) for its diagonals, warpgroup 0 {0, 3, 4, 7} and 1
//    {1, 2, 5, 6}: 18 products each into 4 accumulators of 32 registers a
//    thread, then hands the buffer back. setmaxnreg gives them 200
//    registers a thread and the loader and splitter 56.
//  - split K: the wrapper cuts the summed k (the pairs' 32-k tiles, one
//    after the other) into chunks so that a launch fills the card's SMs.
//    A block folds its diagonals into 64-bit values, the two product
//    warpgroups swap halves through shared memory, and each stores half of
//    the tile; when the launch has more than one chunk the stores are
//    atomic adds into an output the wrapper zeroed (integer addition: exact
//    in any order).
// The batch index g = g0 * b1 + g1 reaches an operand at ptr + g0 * s0 + g1 *
// s1, so an operand shared across the party and batch grid has s0 = s1 = 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 4;
constexpr int BM = 64;             // output rows of a block: the wgmma M
constexpr int BN = 64;             // output columns of a block: the wgmma N
constexpr int BK = 32;             // k of a step: one wgmma k32 of int8
constexpr int kThreads = 512;      // loader, splitter and two product warpgroups
constexpr int kAcc = 32;           // accumulator registers of one 64 x 64 product
constexpr int kStages = 3;         // int64 staging ring
constexpr int kBufs = 2;           // limb-plane buffers
constexpr int kLimbs = 8;
constexpr int kMaxFlushK = 8192;   // summed k a block may contract before its fold
constexpr int kPitch = BK + 2;     // staging row: 272 bytes, 16-byte aligned
constexpr int kStageBytes = 64 * kPitch * 8;       // one operand's staged tile
constexpr int kPlaneBytes = 64 * BK;                // one limb plane of a tile
constexpr int kPlaneSet = kLimbs * kPlaneBytes;     // an operand's 8 planes
constexpr int kPlaneBuf = 2 * kPlaneSet;           // A's and B's planes of a step
constexpr int kStagingOffset = kBufs * kPlaneBuf;
constexpr int kBarOffset = kStagingOffset + kStages * 2 * kStageBytes;
// the plane buffers, the staging ring, and one full and one empty mbarrier
// for each stage and buffer: 170,064 bytes
constexpr int kSmemBytes = kBarOffset + 2 * (kStages + kBufs) * 8;
// registers a thread after setmaxnreg: 2 x 128 x (200 + 56) = 65,536
constexpr int kProductRegs = 200;
constexpr int kFeedRegs = 56;
// an mbarrier wait that has not finished after this many tries traps, so
// that a fault in the schedule ends the launch with an error
constexpr long long kMaxTries = 1ll << 24;
// no-swizzle K-major core matrices (8 rows x 16 bytes, 128 contiguous
// bytes): the two 16-k halves of an 8-row group sit kKHalf bytes apart,
// consecutive 8-row groups kGroup bytes
constexpr int kKHalf = 128;
constexpr int kGroup = 256;
constexpr unsigned long long kBias = 0x8080808080808080ull;

static_assert(8ll * kMaxFlushK * (1 << 14) < (1ll << 31), "diagonal sums must fit int32");
static_assert(BM == 64 && BN == 64, "staging and split assume 64-row tiles");

}  // namespace

struct Operand {
  const long long* ptr;
  long long s0;  // stride of the outer batch index (party axis)
  long long s1;  // stride of the flattened inner batch index
  long long sr;  // row stride
  long long sc;  // column stride
};

struct MMArgs {
  Operand a[kMaxPairs];
  Operand b[kMaxPairs];
  long long k[kMaxPairs];
  int n_pairs;
};

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  // start address; leading byte offset (K-major: between core matrices
  // along k) and stride byte offset (between 8-row groups), in 16-byte
  // units; base offset 0, layout type 0 (no swizzle)
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kKHalf >> 4) << 16) | (static_cast<uint64_t>(kGroup >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A (64 x 32 int8, this thread's fragment in registers) @ B (32 x 64
// int8, K-major in shared memory), int32 sums
__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the diagonals s = i + j of product warpgroup W, {0, 3, 4, 7} and {1, 2,
// 5, 6}: 18 of the 36 plane products each
template <int W>
__device__ __forceinline__ constexpr int diag(int d) {
  return W == 0 ? (d == 0 ? 0 : d == 1 ? 3 : d == 2 ? 4 : 7)
                : (d == 0 ? 1 : d == 1 ? 2 : d == 2 ? 5 : 6);
}

// 4 words -> their byte planes: o_i byte e = byte i of a_e
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint32_t& o0, uint32_t& o1, uint32_t& o2,
                                           uint32_t& o3) {
  const uint32_t p0 = __byte_perm(a0, a1, 0x5140), p1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t q0 = __byte_perm(a2, a3, 0x5140), q1 = __byte_perm(a2, a3, 0x7362);
  o0 = __byte_perm(p0, q0, 0x5410);
  o1 = __byte_perm(p0, q0, 0x7632);
  o2 = __byte_perm(p1, q1, 0x5410);
  o3 = __byte_perm(p1, q1, 0x7632);
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it
__device__ __forceinline__ void pin(int (&d)[kAcc]) {
#pragma unroll
  for (int e = 0; e < kAcc; ++e) asm volatile("" : "+r"(d[e])::"memory");
}

// 4 int64 elements -> their balanced digits' bytes, plane by plane: w[i]
// byte e = digit i of x_e
__device__ __forceinline__ void digits4(ulonglong2 x01, ulonglong2 x23, uint32_t (&w)[kLimbs]) {
  const unsigned long long d0 = (x01.x + kBias) ^ kBias, d1 = (x01.y + kBias) ^ kBias;
  const unsigned long long d2 = (x23.x + kBias) ^ kBias, d3 = (x23.y + kBias) ^ kBias;
  transpose4(static_cast<uint32_t>(d0), static_cast<uint32_t>(d1), static_cast<uint32_t>(d2),
             static_cast<uint32_t>(d3), w[0], w[1], w[2], w[3]);
  transpose4(static_cast<uint32_t>(d0 >> 32), static_cast<uint32_t>(d1 >> 32),
             static_cast<uint32_t>(d2 >> 32), static_cast<uint32_t>(d3 >> 32), w[4], w[5], w[6],
             w[7]);
}

// One operand's copies for a loader thread: 16 elements of a 64 x 32 tile,
// consecutive threads on the operand's unit-stride axis where it has one.
struct Feed {
  const long long* ptr;  // this thread's first element of the current tile
  long long tile_step;   // elements from one tile of a pair to the next
  long long j_step;      // elements between this thread's 16 copies
  int r0, kk0;           // this thread's first row and k in the tile
  int r_left;            // rows from r0 to the operand's edge
  bool kfast;            // k is the unit-stride axis
};

__device__ __forceinline__ Feed make_feed(const Operand& op, long long s_row, long long s_k,
                                          int g0, int g1, int row0, int rows, long long k0) {
  Feed f;
  const int t = threadIdx.x & 127;
  f.kfast = s_k == 1;
  f.r0 = f.kfast ? t >> 5 : t & 63;
  f.kk0 = f.kfast ? t & 31 : t >> 6;
  f.ptr = op.ptr + g0 * op.s0 + g1 * op.s1 + (row0 + f.r0) * s_row + (k0 + f.kk0) * s_k;
  f.tile_step = BK * s_k;
  f.j_step = f.kfast ? 4 * s_row : 2 * s_k;
  f.r_left = rows - row0 - f.r0;
  return f;
}

// copies of one operand's tile into staging [row][k]; k_left = K - k0
__device__ __forceinline__ void issue(const Feed& f, uint32_t dst, long long k_left,
                                      const long long* safe) {
  const long long* q = f.ptr;
  const long long kl = k_left - f.kk0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = f.kfast ? f.r0 + 4 * j : f.r0;
    const int kk = f.kfast ? f.kk0 : f.kk0 + 2 * j;
    const bool ok = f.kfast ? (4 * j < f.r_left && kl > 0) : (f.r_left > 0 && 2 * j < kl);
    cp_async8(dst + (r * kPitch + kk) * 8, ok ? q : safe, ok ? 8 : 0);
    q += f.j_step;
  }
}

// 8 k of row r (k 8q..) of a staged tile -> their bytes of its 8 limb
// planes, K-major
__device__ __forceinline__ void split(const unsigned char* stage, uint32_t planes, int r, int q) {
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(stage + (r * kPitch + 8 * q) * 8);
  const uint32_t dst = planes + (r >> 3) * kGroup + (q >> 1) * kKHalf + (r & 7) * 16 + (q & 1) * 8;
  uint32_t w0[kLimbs], w1[kLimbs];
  digits4(src[0], src[1], w0);
  digits4(src[2], src[3], w1);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i)
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst + i * kPlaneBytes), "r"(w0[i]),
                 "r"(w1[i])
                 : "memory");
}

// this thread's wgmma A fragment of each of A's limb planes: warp w of the
// warpgroup holds rows 16w + l / 4 (+ 8) and k 4 (l % 4) (+ 16) of lane l,
// 4 k a register, which are the 4 core matrices ldmatrix hands it
__device__ __forceinline__ void load_frag(uint32_t planes, uint32_t (&frag)[kLimbs][4]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int m = lane >> 3, row = 16 * warp + (lane & 7) + 8 * (m & 1);
  const uint32_t src = planes + (row >> 3) * kGroup + (m >> 1) * kKHalf + (row & 7) * 16;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(frag[i][0]), "=r"(frag[i][1]), "=r"(frag[i][2]), "=r"(frag[i][3])
                 : "r"(src + i * kPlaneBytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrives on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > kMaxTries) __trap();
  }
}

// The loads of a block: the pair and k of the next tile, and each
// operand's copies.
struct Cursor {
  const MMArgs& args;
  int g0, g1, m0, n0, M, N;
  int p;
  long long k0;
  Feed fa, fb;

  __device__ __forceinline__ void start(int pair, long long k) {
    p = pair;
    k0 = k;
    fa = make_feed(args.a[p], args.a[p].sr, args.a[p].sc, g0, g1, m0, M, k0);
    fb = make_feed(args.b[p], args.b[p].sc, args.b[p].sr, g0, g1, n0, N, k0);
  }

  // copies of the next tile into the stage at dst; advances by one tile
  __device__ __forceinline__ void load(uint32_t dst) {
    issue(fa, dst, args.k[p] - k0, args.a[p].ptr);
    issue(fb, dst + kStageBytes, args.k[p] - k0, args.b[p].ptr);
    if (k0 + BK < args.k[p]) {
      k0 += BK;
      fa.ptr += fa.tile_step;
      fb.ptr += fb.tile_step;
    } else if (p + 1 < args.n_pairs) {
      start(p + 1, 0);
    }
  }
};

// mbarriers: a stage's full and empty, a plane buffer's full and empty
__device__ __forceinline__ uint32_t stage_full(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t stage_empty(uint32_t bars, int s) {
  return bars + 8 * (kStages + s);
}
__device__ __forceinline__ uint32_t buf_full(uint32_t bars, int b) {
  return bars + 8 * (2 * kStages + b);
}
__device__ __forceinline__ uint32_t buf_empty(uint32_t bars, int b) {
  return bars + 8 * (2 * kStages + kBufs + b);
}

// The loader warpgroup: each step's tiles into the staging ring, as soon as
// their stage is free
__device__ __forceinline__ void load_steps(Cursor& cur, int steps, uint32_t staging0,
                                           uint32_t bars) {
  for (int u = 0; u < steps; ++u) {
    const int s = u % kStages;
    mbar_wait(stage_empty(bars, s), ((u / kStages) & 1) ^ 1);
    cur.load(staging0 + s * 2 * kStageBytes);
    mbar_arrive_copies(stage_full(bars, s));
  }
}

// The splitter warpgroup: each staged step into a buffer of limb planes,
// thread t taking 8 k of row t % 64 of A and of B's column, twice
__device__ __forceinline__ void split_steps(int steps, const unsigned char* staging,
                                            uint32_t planes0, uint32_t bars) {
  const int t = threadIdx.x & 127, r = t & 63, q = t >> 6;
  for (int u = 0; u < steps; ++u) {
    const int s = u % kStages, b = u % kBufs;
    mbar_wait(stage_full(bars, s), (u / kStages) & 1);
    mbar_wait(buf_empty(bars, b), ((u / kBufs) & 1) ^ 1);
    const unsigned char* stage = staging + s * 2 * kStageBytes;
    const uint32_t planes = planes0 + b * kPlaneBuf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split(stage, planes, r, q + 2 * h);
      split(stage + kStageBytes, planes + kPlaneSet, r, q + 2 * h);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    mbar_arrive(stage_empty(bars, s));
    mbar_arrive(buf_full(bars, b));
  }
}

// Product warpgroup W: each step's 18 products into its four diagonals,
// then the fold and the stores of half of the tile
template <int W>
__device__ __forceinline__ void product_steps(int steps, unsigned char* smem, uint32_t bars,
                                              const Cursor& at,
                                              unsigned long long* __restrict__ out, int g,
                                              int accumulate) {
  const uint32_t planes0 = smem_u32(smem);
  int acc[4][kAcc];
  uint32_t frag[kLimbs][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[d][e] = 0;
    pin(acc[d]);
  }
  for (int u = 0; u < steps; ++u) {
    const int b = u % kBufs;
    mbar_wait(buf_full(bars, b), (u / kBufs) & 1);
    const uint32_t planes = planes0 + b * kPlaneBuf;
    load_frag(planes, frag);
    wgmma_fence();
    const uint32_t b_planes = planes + kPlaneSet;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i)
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (diag<W>(d) >= i)
          wgmma_s8(acc[d], frag[i], smem_desc(b_planes + (diag<W>(d) - i) * kPlaneBytes));
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(buf_empty(bars, b));
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) pin(acc[d]);

  // fold: out = sum_s (int64) acc_s << 8s mod 2^64. The accumulator layout
  // of wgmma: warp w of the group holds rows 16w.., lane l row l / 4 (+ 8)
  // and columns 2 (l % 4) (+ 1) of each 8-column chunk. Each warpgroup
  // folds its diagonals, hands half of its values to the other warpgroup
  // through the staging ring (free once every step is split), and adds the
  // other's half to its own.
  constexpr int kHalf = kAcc / 2;
  unsigned long long v[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    v[e] = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      v[e] += static_cast<unsigned long long>(static_cast<long long>(acc[d][e]))
              << (8 * diag<W>(d));
  }
  unsigned long long* swap = reinterpret_cast<unsigned long long*>(smem + kStagingOffset);
  const int tw = threadIdx.x & 127;
#pragma unroll
  for (int h = 0; h < kHalf; ++h) swap[(W * kHalf + h) * 128 + tw] = v[(1 - W) * kHalf + h];
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two product warpgroups
  const int lane = threadIdx.x & 31, warp = tw >> 5;
#pragma unroll
  for (int h = 0; h < kHalf; ++h) {
    const int e = W * kHalf + h;
    const unsigned long long val = v[e] + swap[((1 - W) * kHalf + h) * 128 + tw];
    const int row = at.m0 + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
    const int col = at.n0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
    if (row < at.M && col < at.N) {
      unsigned long long* o = out + (static_cast<long long>(g) * at.M + row) * at.N + col;
      if (accumulate)
        atomicAdd(o, val);
      else
        *o = val;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ring_mm_kernel(unsigned long long* __restrict__ out, int b1, int M, int N, int m_tiles,
               int chunk, int k_tiles, int accumulate, const __grid_constant__ MMArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem + kBarOffset);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(stage_full(bars, s), 128);   // the loaders' copies
      mbar_init(stage_empty(bars, s), 128);  // the splitters
    }
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(buf_full(bars, b), 128);   // the splitters
      mbar_init(buf_empty(bars, b), 256);  // the two product warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g = blockIdx.z;
  const int g0 = g / b1;
  const int m0 = static_cast<int>(blockIdx.y % m_tiles) * BM;
  Cursor cur{args, g0, g - g0 * b1, m0, static_cast<int>(blockIdx.x) * BN, M, N};
  const int t_begin = (blockIdx.y / m_tiles) * chunk;
  const int steps = min(k_tiles - t_begin, chunk);
  // warp-uniform in the compiler's eyes, so that setmaxnreg takes effect
  const int role = __shfl_sync(0xffffffff, static_cast<int>(threadIdx.x) >> 7, 0);
  if (role == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFeedRegs));
    // the block's first tile: its pair and k
    int p = 0, t = t_begin;
    while (p < args.n_pairs - 1) {
      const int tp = static_cast<int>((args.k[p] + BK - 1) / BK);
      if (t < tp) break;
      t -= tp;
      ++p;
    }
    cur.start(p, static_cast<long long>(t) * BK);
    load_steps(cur, steps, smem_u32(smem + kStagingOffset), bars);
  } else if (role == 1) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFeedRegs));
    split_steps(steps, smem + kStagingOffset, smem_u32(smem), bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kProductRegs));
    if (role == 2)
      product_steps<0>(steps, smem, bars, cur, out, g, accumulate);
    else
      product_steps<1>(steps, smem, bars, cur, out, g, accumulate);
  }
}

}  // namespace

// out: (b0 * b1, M, N) int64, contiguous; zeroed by the caller when
// `accumulate` (more than one chunk). chunk: 32-k tiles of the summed k per
// block, at most flush_k / 32, flush_k at most kMaxFlushK. Returns
// cudaGetLastError().
extern "C" int ring_mm_launch(long long* out, int b0, int b1, int M, int N, const MMArgs* args,
                              int chunk, int flush_k, int accumulate, void* stream) {
  if (args->n_pairs < 1 || args->n_pairs > kMaxPairs) return cudaErrorInvalidValue;
  if (flush_k > kMaxFlushK || chunk < 1 || static_cast<long long>(chunk) * BK > flush_k)
    return cudaErrorInvalidValue;
  long long k_tiles = 0;
  for (int p = 0; p < args->n_pairs; ++p) k_tiles += (args->k[p] + BK - 1) / BK;
  const long long splits = (k_tiles + chunk - 1) / chunk;
  const int m_tiles = (M + BM - 1) / BM;
  if (k_tiles < 1 || (splits > 1 && !accumulate) || m_tiles * splits > 65535)
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        ring_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    attr_set = true;
  }
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>(m_tiles * splits), b0 * b1);
  ring_mm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<unsigned long long*>(out), b1, M, N, m_tiles, chunk,
      static_cast<int>(k_tiles), accumulate, *args);
  return static_cast<int>(cudaGetLastError());
}
