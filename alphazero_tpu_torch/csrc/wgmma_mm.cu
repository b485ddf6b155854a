// wgmma_mm: the matrix products rebuilt around Hopper's own machinery
// (sm_90a): wgmma from swizzled shared memory, TMA loads that complete on
// mbarriers, a ring of stages, persistent blocks.
//
// Replaces four Pallas TPU probe kernels of the JAX package:
//
//   az_s8_mm_resident  tools/profile_fused_shapes.py::pallas_mm
//                      out = a @ b, s8 x s8 -> s32, a [M, K], b [K, N <= 128]
//                      with all of `b` resident in shared memory
//   az_s8_mm_multi     tools/profile_fused_shapes.py::pallas_mm_multi (:68)
//                      out = sum_t a @ b[t], s8 -> s32, b [taps, K, N]: the
//                      resident kernel with every tap's `b` resident, or
//                      the tiled kernel with the taps laid end to end in K
//   az_wgmma_tiled     tools/profile_pallas_mm.py::make_pallas_mm
//                      out = a @ b, s8 -> s32 or bf16 -> f32, any size
//                      (also takes s8_mm when `b` is too large to be resident)
//   az_chained_dot     tools/profile_inkernel_dot.py::chained_dot
//                      R times a <- tile(requant(a @ b), K / N), then a @ b,
//                      s8 -> s32 or bf16 -> f32, a band of 64 rows in
//                      registers for all R + 1 products (its design is
//                      noted at the kernel below)
//
// What bounds them on the card, and what the designs do about it.
//
// The int8 trunk's shapes ([115200, 576] x [576, 64] for a 3x3 conv) are
// bound by bytes: 66 MB of `a` in and 29 MB of s32 out for 8.5 GOP, about
// 29 us at 3.35 TB/s against 4 us of tensor-core time.  The work is
// streaming `a` once and writing the output once, so the resident kernel runs
// one persistent block per SM that loads `b` ONCE, keeps it for every row
// tile, and walks row tiles of `a` strided by the grid.  `a` arrives through
// a ring of [128 rows x 128 bytes] TMA boxes (16 KB a stage, up to 8 stages
// in flight per SM) issued by one producer thread; two consumer warpgroups
// take 64 rows each and run wgmma m64nNk32 with both operands read from
// shared memory.  While they store a tile's s32 output straight from their
// registers (each quad of lanes writes one full 32-byte sector), the
// producer is already filling the ring with the next tiles' loads.
//
// The taps product has the same shape of work: at the probe, [14400, 128] x
// [5, 128, 64], the call moves 5.57 MB (a 1.84 MB, b 0.04 MB, out 3.69 MB),
// 1.66 us at 3.35 TB/s against 0.60 us of tensor time, so it is bound by
// bytes, and a must cross from memory once, not once a tap.  The resident
// kernel takes a tap count: shared memory holds `taps` images of b[t] one
// after another, and each [128 x 128-byte] box of `a` that arrives is run
// against every tap's panel into the same accumulator, one ring stage and
// one `empty` arrival for all taps.  With taps = 1 it is s8_mm's kernel.  At
// the probe 14400 rows make 113 tiles for 132 SMs, one tile a block, so
// nothing overlaps and what a block does before its first wgmma (launch,
// building the 40 KB image of b) is on the critical path: b arrives in
// 16-byte pieces of four rows, several pieces in flight a thread, where its
// rows allow it.  That image is the largest part of the call at the probe;
// forms of build_b_image that coalesced its loads, cut its index arithmetic,
// spread it over more threads or issued each tap's wgmma as soon as the tap
// was written all measured slower (PERF.md).  Where the taps' images exceed
// the resident limit (or
// N > 128) the tiled kernel runs over (tap, K panel) stages, with `a`'s K
// coordinate restarting at each tap (re-read from L2) and b transposed into
// scratch as [N, taps x Kp], each tap's K padded with zeros to Kp.
//
// The square probe shape [8192, 2048] x [2048, 2048] is bound by operations
// (35 us s8, 69 us bf16 at the tensor cores' peak).  The tiled kernel is the
// usual Hopper shape: 128 x 256 output tiles, K steps of 128 bytes, a
// four-stage ring (16 KB of `a` + 32 KB of `b` a stage), one producer thread
// issuing TMA, two consumer warpgroups each holding a 64 x 256 accumulator
// (128 registers a thread; setmaxnreg moves the producer's registers to
// them), persistent over the tiles so that the next tile's loads are in
// flight during a tile's stores.  A stage is released one wgmma group late
// (wait_group 1), so the tensor cores always have a group queued.
//
// `b` is row-major [K, N]: N is contiguous.  For bf16, wgmma takes that as it
// lies (the descriptor's MN-major canonical layout and the instruction's
// transpose bit).  For 8-bit types wgmma takes only K-major operands, so the
// s8 `b` has to be transposed:
//   * resident kernel: inside the block, once per block.  The consumer
//     threads read four rows of `b` (16 or 4 bytes of each), transpose 4 x 4
//     byte blocks in registers with PRMT and write them K-major into the
//     128-byte-swizzled layout the descriptor names (N padded up to 32 / 64
//     / 128 there, K up to 32, with zeros; no padded copy of `b` is made by
//     the caller).  36 KB x 132 blocks out of L2 is nothing beside the 95 MB
//     the call moves.
//   * tiled kernel: a small transposition kernel in this file writes `b` as
//     [N, K] into scratch the caller allocates, and the product then loads it
//     by TMA like `a`.  4 MB each way takes a few microseconds against a 35 us
//     bound; doing it inside the block instead would put 256 x 128 PRMT
//     transpositions between every stage's arrival and its wgmma, on the
//     critical path of a kernel that is bound by issue slots and tensor time.
//
// Ragged edges.  A tensor map knows the true M, N and K: a box that reaches
// past them is zero-filled by the TMA unit, so no padded copy is needed for
// size.  What TMA does need is a 16-byte aligned base and a row pitch that
// is a multiple of 16 bytes; the caller passes the pitch (`lda`, `ldb`) and
// copies a matrix only when its own pitch or base does not qualify (the
// stem's K = 99 when it arrives densely packed).  Stores are masked by row
// and column and go out as 8-byte pairs when N is even, else one by one.
//
// Integer sums wrap in int32 (no .satfinite), like the TPU kernels'.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned char byte_t;

constexpr int WG_THREADS = 128;          // one warpgroup
constexpr int THREADS = 3 * WG_THREADS;  // two consumer warpgroups + producer
constexpr int PRODUCER_THREAD = 2 * WG_THREADS;
constexpr int BM = 128;                  // rows of `a` per tile, 64 a warpgroup
constexpr int ROW_BYTES = 128;           // K extent of a stage: one swizzle row
constexpr int A_STAGE = BM * ROW_BYTES;  // 16 KB
constexpr int HALF_A = 64 * ROW_BYTES;   // the second warpgroup's rows
constexpr int SMEM_MAX = 232448;         // bytes a block may use on sm_90

// Resident kernel: `b` may take this much shared memory, the ring the rest.
constexpr int RESIDENT_B_MAX = 96 * 1024;
constexpr int R_STAGES = 8;
constexpr int R_SMEM_FIXED = 1024 + R_STAGES * A_STAGE + 16 * R_STAGES;
static_assert(R_SMEM_FIXED + RESIDENT_B_MAX <= SMEM_MAX, "ring + b must fit");

// Tiled kernel.
constexpr int TN = 256;                  // output columns per tile
constexpr int B_STAGE = TN * ROW_BYTES;  // 32 KB in either layout
constexpr int T_STAGES = 4;
constexpr int T_STAGE = A_STAGE + B_STAGE;
constexpr int T_SMEM = 1024 + T_STAGES * T_STAGE + 16 * T_STAGES;
static_assert(T_SMEM <= SMEM_MAX, "the tiled kernel's ring must fit");

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of the given parity is complete.  A new
// barrier counts as having completed a phase of parity 1.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the tensor map at element coordinates (c0 inner, c1 outer) into
// shared memory; its bytes are counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders ordinary shared-memory stores before reads by the async proxy
// (wgmma reading its operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving accumulator accesses across a wgmma batch.
__device__ __forceinline__ void fence_reg(int32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

template <typename T, int N>
__device__ __forceinline__ void fence_acc(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

// Shared-memory matrix descriptor, 128-byte swizzle.  `addr` is a shared
// address inside a 1024-byte aligned tile; offsets are in bytes.
//   K-major (rows of 128 bytes of K, 8-row groups 1024 bytes apart):
//     lbo unused (1), sbo = 1024; 32 bytes further along K: addr + 32.
//   MN-major (K rows of 128 bytes = 64 bf16 of N, 8 K rows 1024 bytes apart):
//     lbo = distance between 64-column blocks, sbo = 1024; 16 further along
//     K: addr + 16 * 128.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define AZ_L0 "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
#define AZ_L1 "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
#define AZ_L2 "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
#define AZ_L3 "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
#define AZ_L4 "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79"
#define AZ_L5 "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
#define AZ_L6 \
  "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111"
#define AZ_L7                                                                  \
  "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126," \
  "%127"
#define AZ_O4(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define AZ_O16(c, d, i) \
  AZ_O4(c, d, i), AZ_O4(c, d, i + 4), AZ_O4(c, d, i + 8), AZ_O4(c, d, i + 12)
#define AZ_O32(c, d, i) AZ_O16(c, d, i), AZ_O16(c, d, i + 16)
#define AZ_O64(c, d, i) AZ_O32(c, d, i), AZ_O32(c, d, i + 32)
#define AZ_O128(c, d, i) AZ_O64(c, d, i), AZ_O64(c, d, i + 64)

// d (+)= A x B for one 64-row tile of A: m64nNk32, s8 x s8 -> s32, both
// operands K-major in shared memory.  scale_d == 0 overwrites d.
template <int N> struct S8Mma;

template <> struct S8Mma<32> {
  static __device__ __forceinline__ void run(int32_t (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" AZ_L0
        "}, %16, %17, p;\n}\n"
        : AZ_O16("+r", d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct S8Mma<64> {
  static __device__ __forceinline__ void run(int32_t (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" AZ_L0 "," AZ_L1
        "}, %32, %33, p;\n}\n"
        : AZ_O32("+r", d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct S8Mma<128> {
  static __device__ __forceinline__ void run(int32_t (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" AZ_L0 "," AZ_L1
        "," AZ_L2 "," AZ_L3 "}, %64, %65, p;\n}\n"
        : AZ_O64("+r", d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct S8Mma<256> {
  static __device__ __forceinline__ void run(int32_t (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" AZ_L0 "," AZ_L1
        "," AZ_L2 "," AZ_L3 "," AZ_L4 "," AZ_L5 "," AZ_L6 "," AZ_L7
        "}, %128, %129, p;\n}\n"
        : AZ_O128("+r", d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// m64n256k16, bf16 x bf16 -> f32; A K-major, B MN-major (transpose bit set).
__device__ __forceinline__ void bf16_mma_256(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" AZ_L0 "," AZ_L1
      "," AZ_L2 "," AZ_L3 "," AZ_L4 "," AZ_L5 "," AZ_L6 "," AZ_L7
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : AZ_O128("+f", d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64nNk16, bf16 x bf16 -> f32; A K-major, B MN-major (transpose bit set).
template <int N> struct Bf16Mma;

template <> struct Bf16Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" AZ_L0 "," AZ_L1
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : AZ_O32("+f", d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <> struct Bf16Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" AZ_L0 "," AZ_L1
        "," AZ_L2 "," AZ_L3 "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : AZ_O64("+f", d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The same with A from registers (a warp's 16 rows: a[0] row g, a[1] row
// g + 8, a[2] and a[3] the same rows 16 bytes further along K; g = lane / 4,
// 4 bytes of K at 4 (lane % 4)), B from shared memory.  s8: m64nNk32;
// bf16: m64nNk16, B MN-major (transpose bit set).
template <int N> struct S8MmaRS;

template <> struct S8MmaRS<32> {
  static __device__ __forceinline__ void run(int32_t (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" AZ_L0
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : AZ_O16("+r", d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <> struct S8MmaRS<64> {
  static __device__ __forceinline__ void run(int32_t (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" AZ_L0 "," AZ_L1
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : AZ_O32("+r", d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <> struct S8MmaRS<128> {
  static __device__ __forceinline__ void run(int32_t (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" AZ_L0 "," AZ_L1
        "," AZ_L2 "," AZ_L3 "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : AZ_O64("+r", d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <int N> struct Bf16MmaRS;

template <> struct Bf16MmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" AZ_L0 "," AZ_L1
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : AZ_O32("+f", d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <> struct Bf16MmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" AZ_L0 "," AZ_L1
        "," AZ_L2 "," AZ_L3 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : AZ_O64("+f", d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// ------------------------------------------------------------ shared pieces

// w[j] = byte j of r[0], r[1], r[2], r[3] (r[0]'s in the lowest byte): the
// 4 x 4 byte block of four rows transposed, with PRMT.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&w)[4]) {
  const uint32_t x0 = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t x1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t y0 = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t y1 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(x0, x1, 0x5410);
  w[1] = __byte_perm(x0, x1, 0x7632);
  w[2] = __byte_perm(y0, y1, 0x5410);
  w[3] = __byte_perm(y0, y1, 0x7632);
}

// The 4 x 4 byte block of row-major b [K, N] at (k, n), transposed: w[j]
// holds b[k..k+3][n + j], lowest k in the lowest byte; zeros outside b.
// `vec`: N % 4 == 0 and b is 4-byte aligned (n is always a multiple of 4).
__device__ __forceinline__ void load_bt4(const byte_t* __restrict__ b, int K,
                                         int N, int k, int n, bool vec,
                                         uint32_t (&w)[4]) {
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = 0;
    if (k + i < K && n < N) {
      const byte_t* p = b + static_cast<size_t>(k + i) * N + n;
      if (vec) {
        r[i] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) r[i] |= static_cast<uint32_t>(__ldg(p + c)) << (8 * c);
      }
    }
  }
  transpose4x4(r, w);
}

constexpr int BT_BATCH = 6;  // 16-byte pieces of four rows of s8 b in flight

__device__ __forceinline__ uint32_t word_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Writes the K-major, 128-byte-swizzled image of s8 b [taps, K, N] (taps
// row-major K x N matrices one after another) at `sm`, as the resident
// product and the chained dot read it: for each tap, ceil(K / 128) panels of
// [NP rows (n)][128 bytes of K], tap t's panel p at (t panels + p) NP 128
// bytes (a multiple of 1024, so every panel is swizzle-aligned).  K is
// covered up to the last 32-byte wgmma step and N up to NP, with zeros.
// Threads `tid` of `nthreads` share the work.  Mode 2 reads four rows of 16
// columns as four 16-byte loads, BT_BATCH such items in flight a thread,
// and neighbouring threads take neighbouring groups of four rows, so a
// warp's stores fill whole 128-byte rows of a panel, one to a bank; modes 1
// and 0 read 4 x 4 byte blocks (load_bt4).
template <int NP>
__device__ __forceinline__ void build_b_image(byte_t* sm,
                                              const byte_t* __restrict__ b,
                                              int K, int N, int taps, int mode,
                                              int tid, int nthreads) {
  const int panels = (K + ROW_BYTES - 1) / ROW_BYTES;
  const int k4s = (K + 31) / 32 * 8;  // groups of 4 rows up to the last step
  // w[j]: K bytes k .. k + 3 of column n + j of tap t.
  auto put = [&](int t, int k, int n, const uint32_t(&w)[4]) {
    const int kk = k % ROW_BYTES;
    byte_t* panel = sm + (t * panels + k / ROW_BYTES) * (NP * ROW_BYTES);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = n + j;
      const int off =
          row * ROW_BYTES + ((((kk >> 4) ^ (row & 7)) << 4) | (kk & 15));
      *reinterpret_cast<uint32_t*>(panel + off) = w[j];
    }
  };
  if (mode == 2) {
    constexpr int N16 = NP / 16;
    const int items = taps * k4s * N16;  // item: (tap, n16, k4), k4 fastest
    for (int i0 = tid; i0 < items; i0 += nthreads * BT_BATCH) {
      uint4 r[BT_BATCH][4];
#pragma unroll
      for (int u = 0; u < BT_BATCH; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= items) continue;
        const int k = 4 * (i % k4s), n = 16 * ((i / k4s) % N16);
        const int t = i / (k4s * N16);
        const byte_t* p = b + (static_cast<size_t>(t) * K + k) * N + n;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          r[u][q] = k + q < K && n < N
                        ? __ldg(reinterpret_cast<const uint4*>(p + q * N))
                        : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < BT_BATCH; ++u) {
        const int i = i0 + u * nthreads;
        if (i >= items) continue;
        const int k = 4 * (i % k4s), n = 16 * ((i / k4s) % N16);
        const int t = i / (k4s * N16);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t rows[4] = {word_of(r[u][0], c), word_of(r[u][1], c),
                                    word_of(r[u][2], c), word_of(r[u][3], c)};
          uint32_t w[4];
          transpose4x4(rows, w);
          put(t, k, n + 4 * c, w);
        }
      }
    }
    return;
  }
  const int items = taps * k4s * (NP / 4);  // item: (tap, k4, n4), n4 fastest
  for (int i = tid; i < items; i += nthreads) {
    const int n = (i % (NP / 4)) * 4, k = (i / (NP / 4)) % k4s * 4;
    const int t = i / ((NP / 4) * k4s);
    uint32_t w[4];
    load_bt4(b + static_cast<size_t>(t) * K * N, K, N, k, n, mode != 0, w);
    put(t, k, n, w);
  }
}

__device__ __forceinline__ void st2(int32_t* p, int32_t x, int32_t y) {
  *reinterpret_cast<int2*>(p) = make_int2(x, y);
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// One thread's share of a 64 x (2 * NREG) accumulator to row-major out
// [M, N].  Register 4j + 2h + e is row `row0 + 8h`, column `col0 + 8j + e`
// (row0 = tile row + 16 * warp + lane / 4, col0 = tile column + 2 * (lane %
// 4)); rows >= M and columns >= N are masked.  `pairs`: N is even and out is
// 8-byte aligned, so a register pair goes out as one 8-byte store.
template <typename T, int NREG>
__device__ __forceinline__ void store_acc(T* __restrict__ out, int M, int N,
                                          bool pairs, int row0, int col0,
                                          const T (&d)[NREG]) {
#pragma unroll
  for (int j = 0; j < NREG / 4; ++j) {
    const int col = col0 + 8 * j;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      T* p = out + static_cast<size_t>(row) * N + col;
      if (pairs) {
        st2(p, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      } else {
        p[0] = d[4 * j + 2 * h];
        if (col + 1 < N) p[1] = d[4 * j + 2 * h + 1];
      }
    }
  }
}

struct Ring {  // position in a ring of stages; the parity flips on each wrap
  uint32_t stage = 0, phase = 0;
  __device__ __forceinline__ void advance(uint32_t stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ------------------------------------------------- s8, `b` resident on chip

// One committed group of STEPS wgmma m64nNPk32 steps along K (32 bytes a
// step), both operands from shared memory.  The steps are unrolled: with a
// loop of run-time length between the fence and the commit, ptxas fences
// every wgmma (its note C7519), and the taps product ran 1.3 us slower at
// the probe.  `first` overwrites acc.
template <int NP, int STEPS>
__device__ __forceinline__ void s8_mma_group(int32_t (&acc)[NP / 2],
                                             uint64_t da, uint64_t db,
                                             bool first) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks)
    S8Mma<NP>::run(acc, da + 2 * ks, db + 2 * ks, !first || ks != 0);
  wgmma_commit();
}

// out = sum over taps of a @ b[t] (taps = 1: a @ b).  Shared memory (from a
// 1024-byte aligned base):
//   bt    taps x panels x [NP rows (n)][128 bytes of K], 128-byte swizzled
//         (build_b_image)
//   ring  R_STAGES x [128 rows of a][128 bytes of K], as TMA writes them
//   bars  full[R_STAGES], empty[R_STAGES]
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
s8_resident_kernel(const __grid_constant__ CUtensorMap map_a,
                   const byte_t* __restrict__ b, int32_t* __restrict__ out,
                   int M, int N, int K, int taps, int b_mode, int out_pairs) {
  extern __shared__ byte_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  byte_t* const sm = smem_raw + (base - raw);

  const int panels = (K + ROW_BYTES - 1) / ROW_BYTES;
  const int panel_bytes = NP * ROW_BYTES;
  const uint32_t bt = base;
  const uint32_t ring = bt + taps * panels * panel_bytes;
  const uint32_t full = ring + R_STAGES * A_STAGE;
  const uint32_t empty = full + 8 * R_STAGES;
  const int tiles = (M + BM - 1) / BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive + the box's bytes
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    // Producer: one thread keeps the ring full, across tiles.
    if (threadIdx.x == PRODUCER_THREAD) {
      Ring r;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int p = 0; p < panels; ++p) {
          mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
          mbar_expect_tx(full + 8 * r.stage, A_STAGE);
          tma_load_2d(ring + r.stage * A_STAGE, &map_a, full + 8 * r.stage,
                      p * ROW_BYTES, tile * BM);
          r.advance(R_STAGES);
        }
      }
    }
    return;
  }

  // Consumers.  First bring every tap's b in, transposed to K-major and
  // swizzled, while the producer's first loads of `a` are in flight.
  build_b_image<NP>(sm, b, K, N, taps, b_mode, threadIdx.x, 2 * WG_THREADS);
  fence_proxy_async();
  consumers_sync();

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG_THREADS) / 32;
  const int last_steps = ((K - (panels - 1) * ROW_BYTES) + 31) / 32;
  int32_t acc[NP / 2] = {};
  Ring r;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int p = 0; p < panels; ++p) {
      mbar_wait(full + 8 * r.stage, r.phase);
      const uint64_t da =
          make_desc(ring + r.stage * A_STAGE + wg * HALF_A, 16, 1024);
      const int steps = p == panels - 1 ? last_steps : 4;
      fence_acc(acc);
      // This stage of `a` against panel p of every tap, a group a tap.
      for (int t = 0; t < taps; ++t) {
        const uint64_t db =
            make_desc(bt + (t * panels + p) * panel_bytes, 16, 1024);
        const bool first = (p | t) == 0;
        switch (steps) {
          case 4: s8_mma_group<NP, 4>(acc, da, db, first); break;
          case 3: s8_mma_group<NP, 3>(acc, da, db, first); break;
          case 2: s8_mma_group<NP, 2>(acc, da, db, first); break;
          default: s8_mma_group<NP, 1>(acc, da, db, first);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (threadIdx.x % WG_THREADS == 0) mbar_arrive(empty + 8 * r.stage);
      r.advance(R_STAGES);
    }
    store_acc(out, M, N, out_pairs != 0,
              tile * BM + wg * 64 + warp * 16 + lane / 4, 2 * (lane % 4), acc);
  }
}

// ----------------------------------------------------------- tiled product

// bt [N, ldbt] <- b [taps, K, N] (s8): tap t (blockIdx.z) goes to columns
// [t kp, t kp + kp) of bt, zeros past K.  Through a 64 (n) x 128 (k) shared
// tile: reads run along N, writes along K, both in 4-byte words.
__global__ void __launch_bounds__(256)
transpose_s8_kernel(const byte_t* __restrict__ b, byte_t* __restrict__ bt,
                    int K, int N, int ldbt, int kp, int b_vec) {
  __shared__ uint32_t tile[64][33];
  const int k0 = blockIdx.x * 128, n0 = blockIdx.y * 64;
  b += static_cast<size_t>(blockIdx.z) * K * N;
  bt += static_cast<size_t>(blockIdx.z) * kp;
  for (int i = threadIdx.x; i < 32 * 16; i += 256) {
    const int n4 = i % 16, k4 = i / 16;
    uint32_t w[4];
    load_bt4(b, K, N, k0 + 4 * k4, n0 + 4 * n4, b_vec != 0, w);
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[4 * n4 + j][k4] = w[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 32; i += 256) {
    const int kw = i % 32, n = i / 32;
    if (n0 + n < N && k0 + 4 * kw < kp)
      *reinterpret_cast<uint32_t*>(bt + static_cast<size_t>(n0 + n) * ldbt + k0 +
                                   4 * kw) = tile[n][kw];
  }
}

template <int ES> struct Acc;  // ES: bytes per input element
template <> struct Acc<1> { typedef int32_t type; };
template <> struct Acc<2> { typedef float type; };

// s8: out = sum over taps of a @ b[t], with b[t] at columns [t kp, t kp + K)
// of the transposed bt [N, taps kp] that map_b reads; the stages of a tile
// run over (tap, K panel), and a's K coordinate restarts at each tap.  bf16:
// taps = 1.  Shared memory (from a 1024-byte aligned base): T_STAGES x
// { a [128 rows][128 bytes of K];  b: s8 [256 rows (n)][128 bytes of K],
// bf16 four blocks of [64 K rows][128 bytes = 64 columns] }, then full[],
// empty[].
template <int ES>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_tiled_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   typename Acc<ES>::type* __restrict__ out, int M, int N,
                   int K, int tiles_n, int tiles, int out_pairs, int taps,
                   int kp) {
  typedef typename Acc<ES>::type acc_t;
  extern __shared__ byte_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + T_STAGES * T_STAGE;
  const uint32_t empty = full + 8 * T_STAGES;
  constexpr int BK = ROW_BYTES / ES;  // elements of K per stage
  const int tap_steps = (K + BK - 1) / BK;
  const int ksteps = taps * tap_steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == PRODUCER_THREAD) {
      Ring r;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * TN;
        for (int kt = 0; kt < ksteps; ++kt) {
          const uint32_t bar = full + 8 * r.stage;
          const uint32_t sa = base + r.stage * T_STAGE, sb = sa + A_STAGE;
          const int tap = kt / tap_steps, k = (kt - tap * tap_steps) * BK;
          mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
          mbar_expect_tx(bar, T_STAGE);
          tma_load_2d(sa, &map_a, bar, k, m0);
          if constexpr (ES == 1) {
            tma_load_2d(sb, &map_b, bar, tap * kp + k, n0);  // bt [N, taps kp]
          } else {
#pragma unroll
            for (int j = 0; j < TN / 64; ++j)  // b [K, N], 64 columns a box
              tma_load_2d(sb + j * (BK * ROW_BYTES), &map_b, bar, n0 + 64 * j,
                          kt * BK);
          }
          r.advance(T_STAGES);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % WG_THREADS) / 32;
    const bool elected = threadIdx.x % WG_THREADS == 0;
    acc_t acc[TN / 2] = {};
    Ring r;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * TN;
      uint32_t prev = 0;
      for (int kt = 0; kt < ksteps; ++kt) {
        const uint32_t sa = base + r.stage * T_STAGE, sb = sa + A_STAGE;
        mbar_wait(full + 8 * r.stage, r.phase);
        const uint64_t da = make_desc(sa + wg * HALF_A, 16, 1024);
        fence_acc(acc);
        wgmma_fence();
        if constexpr (ES == 1) {
          const uint64_t db = make_desc(sb, 16, 1024);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            S8Mma<TN>::run(acc, da + 2 * ks, db + 2 * ks, (kt | ks) != 0);
        } else {
          const uint64_t db = make_desc(sb, BK * ROW_BYTES, 1024);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            bf16_mma_256(acc, da + 2 * ks, db + ks * ((16 * ROW_BYTES) >> 4),
                         (kt | ks) != 0);
        }
        wgmma_commit();
        // The stage before this one is free once its group is complete;
        // this stage's group stays queued behind it.
        wgmma_wait<1>();
        if (kt > 0 && elected) mbar_arrive(empty + 8 * prev);
        prev = r.stage;
        r.advance(T_STAGES);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (elected) mbar_arrive(empty + 8 * prev);
      store_acc(out, M, N, out_pairs != 0,
                m0 + wg * 64 + warp * 16 + lane / 4, n0 + 2 * (lane % 4), acc);
    }
  }
}

// ------------------------------------------------------------ chained dot
//
// R dependent products on a band of rows, then one more:
//
//   a <- tile(requant(a @ b), K / N)   R times;   return a @ b
//
// requant is (acc >> 8) wrapped to s8 (s8 -> s32), or acc * 0.001 rounded to
// bf16 (bf16 -> f32).  The chain is serial within a band of rows and rows do
// not interact, so one block of one warpgroup owns a band of 64 rows: the
// tensor cores' work per step is small (64 x K x N), and what sets the pace
// is how soon each step's result is the next step's operand.
//
// The design:
//   * `b` is loaded ONCE per block and stays in shared memory: s8 `b` is
//     read in 16-byte pieces of four rows and transposed on arrival (PRMT)
//     into the K-major, 128-byte-swizzled panels the resident s8_mm kernel
//     builds; bf16 `b` is read MN-major as it lies, by TMA, in blocks of
//     [K rows][64 columns] (the instruction's transpose bit).  The band of
//     `a` arrives by TMA, 128-byte swizzled, in [64 rows][128 bytes] panels,
//     while the threads transpose `b`.
//   * Each step is K / 32 bytes wgmma m64nNk32 (s8) or m64nNk16 (bf16) with
//     the sum in registers, then requant in registers.
//   * tile(d, K / N) @ b == sum over j of d @ b[jN : (j+1)N]: exact in int32
//     (the sums wrap), the same f32 terms for bf16.  So the next step's A is
//     only d's N columns, and the K loop's A wraps around them while the `b`
//     descriptor walks all of K.
//   * d never leaves the registers: the requantised accumulator is
//     rearranged into wgmma's A fragments (bf16: the accumulator's pairs
//     are the fragment's, as FlashAttention-3 feeds P; s8: two shuffles
//     within a quad a fragment word), and every step after the first runs
//     wgmma with A from registers: no store, fence or barrier between steps.
//   * A cluster of two blocks splitting N (each block's half of d sent to
//     the other through distributed shared memory, a cluster barrier a
//     step) was built and measured: it lost at 7 of the 8 probe shapes it
//     took and won by 8 % at the eighth, the cluster barrier costing more
//     than the halved tensor time, so it is not kept (PERF.md).
//
// What bounds it: the operation bound (2 M K N (R + 1) at 1,979 TOP/s s8 or
// 989 TFLOP/s bf16) counts all 132 SMs busy all the time, which a chain of
// dependent steps on ceil(M / 64) bands cannot be: the bound is out of
// reach, and the kernel aims at the latency of one step and of the loads
// before the first.
//
// Shared memory (from a 1024-byte aligned base): bt (b, as above), band
// (panels of the `a` band), one mbarrier.
constexpr int CD_ROWS = 64;
constexpr int CD_PANEL = CD_ROWS * ROW_BYTES;  // 8 KB

struct ChainLayout {
  int panels, b_bytes, band_bytes, total;
};

__host__ __device__ __forceinline__ ChainLayout chain_layout(int N, int K,
                                                              int es) {
  ChainLayout l;
  l.panels = (K * es + ROW_BYTES - 1) / ROW_BYTES;
  l.b_bytes = es == 1 ? l.panels * ROW_BYTES * N : K * ROW_BYTES * (N / 64);
  l.band_bytes = l.panels * CD_PANEL;
  l.total = 1024 + l.b_bytes + l.band_bytes + 16;
  return l;
}

template <int ES, int N> struct ChainMma;
template <int N> struct ChainMma<1, N> : S8Mma<N> {};
template <int N> struct ChainMma<2, N> : Bf16Mma<N> {};
template <int ES, int N> struct ChainMmaRS;
template <int N> struct ChainMmaRS<1, N> : S8MmaRS<N> {};
template <int N> struct ChainMmaRS<2, N> : Bf16MmaRS<N> {};

// d = requant(acc) as the A fragments of the next step, set u covering K
// bytes [32 u, 32 u + 32) of d's row (see S8MmaRS).  bf16: the accumulator's
// register pairs are the fragment's (columns 2t, 2t + 1 of each 8).  s8: a
// fragment word holds 4 columns 4t..4t+3, which two lanes of the quad hold
// as pairs, so each lane packs its pairs of two column groups into one word
// and two shuffles fetch the halves it needs.
template <int ES, int N>
__device__ __forceinline__ void requant_to_fragments(
    const typename Acc<ES>::type (&acc)[N / 2], uint32_t (&a)[N * ES / 32][4],
    int lane) {
#pragma unroll
  for (int u = 0; u < N * ES / 32; ++u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (ES == 1) {
          const int j0 = 4 * u + 2 * half;
          auto pair = [&](int j) {
            return (static_cast<uint32_t>(acc[4 * j + 2 * h] >> 8) & 0xffu) |
                   ((static_cast<uint32_t>(acc[4 * j + 2 * h + 1] >> 8) & 0xffu)
                    << 8);
          };
          const uint32_t packed = pair(j0) | (pair(j0 + 1) << 16);
          const int t = lane % 4, src = (lane & ~3) | (2 * (t & 1));
          const uint32_t x = __shfl_sync(0xffffffffu, packed, src);
          const uint32_t y = __shfl_sync(0xffffffffu, packed, src + 1);
          const int sel = (t >> 1) * 16;
          a[u][2 * half + h] =
              ((x >> sel) & 0xffffu) | (((y >> sel) & 0xffffu) << 16);
        } else {
          const int j = 2 * u + half;
          __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * h] * 0.001f, acc[4 * j + 2 * h + 1] * 0.001f);
          a[u][2 * half + h] = *reinterpret_cast<uint32_t*>(&v);
        }
      }
    }
  }
}

// One block: one warpgroup, one band of 64 rows, all of b.
template <int ES, int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
chained_dot_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const byte_t* __restrict__ b,
                   typename Acc<ES>::type* __restrict__ out, int M, int K,
                   int R) {
  typedef typename Acc<ES>::type acc_t;
  extern __shared__ byte_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  byte_t* const sm = smem_raw + (base - raw);

  const ChainLayout l = chain_layout(N, K, ES);
  const int ksteps = K * ES / 32;
  const uint32_t bt = base;
  const uint32_t band = bt + l.b_bytes;
  const uint32_t bar = band + l.band_bytes;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * CD_ROWS;

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, l.band_bytes + (ES == 2 ? l.b_bytes : 0));
    for (int p = 0; p < l.panels; ++p)
      tma_load_2d(band + p * CD_PANEL, &map_a, bar, p * (ROW_BYTES / ES), row0);
    if constexpr (ES == 2) {
      // b [K, N] as it lies: column block c is [K rows][128 bytes] at c K 128.
      for (int c = 0; c < N / 64; ++c)
        for (int k0 = 0; k0 < K; k0 += 64)
          tma_load_2d(bt + c * K * ROW_BYTES + k0 * ROW_BYTES, &map_b, bar,
                      64 * c, k0);
    }
  }
  if constexpr (ES == 1) {
    // b is 16-byte aligned, N a multiple of 16 and K of N (so of 32).
    build_b_image<N>(sm, b, K, N, 1, 2, tid, WG_THREADS);
    fence_proxy_async();
  }
  __syncthreads();
  mbar_wait(bar, 0);

  const int warp = tid / 32, lane = tid % 32;
  auto b_desc = [&](int ks) {
    if constexpr (ES == 1)
      return make_desc(bt + (ks >> 2) * (N * ROW_BYTES) + (ks & 3) * 32, 16,
                       1024);
    else
      return make_desc(bt + ks * 16 * ROW_BYTES, K * ROW_BYTES, 1024);
  };
  constexpr int SETS = N * ES / 32;  // A fragments of one copy of d
  uint32_t frag[SETS][4];
  acc_t acc[N / 2] = {};
  for (int step = 0;; ++step) {
    fence_acc(acc);
    wgmma_fence();
    if (step == 0) {  // A: the band in shared memory
      for (int ks = 0; ks < ksteps; ++ks)
        ChainMma<ES, N>::run(
            acc, make_desc(band + (ks >> 2) * CD_PANEL + (ks & 3) * 32, 16, 1024),
            b_desc(ks), ks != 0);
    } else {  // A: d, from the registers, once for every N columns of K
      for (int k0 = 0; k0 < ksteps; k0 += SETS) {
#pragma unroll
        for (int u = 0; u < SETS; ++u)
          ChainMmaRS<ES, N>::run(acc, frag[u], b_desc(k0 + u), (k0 | u) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int u = 0; u < SETS; ++u) fence_acc(frag[u]);  // read until here
    if (step == R) break;
    requant_to_fragments<ES, N>(acc, frag, lane);
  }
  store_acc(out, M, N, true, row0 + warp * 16 + lane / 4, 2 * (lane % 4), acc);
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is looked up through the
// runtime at first use, so nothing links against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A map over a row-major matrix of `outer` rows of `inner` elements, rows
// `pitch_bytes` apart, read in boxes of box_outer x box_inner elements (a box
// row is at most 128 bytes), 128-byte swizzled, zero-filled past the edges.
cudaError_t make_map(CUtensorMap* map, int es, const void* base, int inner,
                     int outer, long long pitch_bytes, int box_inner,
                     int box_outer) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count() {
  static int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
    return sms;
  }();
  return n;
}

// Allow a kernel the block's full dynamic shared memory.
template <typename Kernel> cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

bool tma_ok(const void* p, long long pitch_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && pitch_bytes % 16 == 0;
}

bool pairs_ok(const void* out, int N) {
  return N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
}

bool words_ok(const void* b, int N) {
  return N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
}

// How build_b_image reads b's rows: 2 in 16-byte pieces (N % 16 == 0 and a
// 16-byte aligned base), 1 in 4-byte words, 0 byte by byte.
int b_read_mode(const void* b, int N) {
  if (N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0) return 2;
  return words_ok(b, N) ? 1 : 0;
}

// Shared memory the resident kernel's image of one K x N b takes:
// ceil(K / 128) panels of NP x 128 bytes, NP = 32, 64 or 128 >= N.
long long resident_b_bytes(int N, int K) {
  const int np = N <= 32 ? 32 : N <= 64 ? 64 : 128;
  return static_cast<long long>((K + ROW_BYTES - 1) / ROW_BYTES) * ROW_BYTES * np;
}

// K columns a tap of the tiled kernel's transposed b takes: rounded up to 16
// bytes (TMA's pitch) for one tap, to 128 (a stage) for several, so that
// every tap starts a stage.
int tap_pitch(int taps, int K) {
  return taps == 1 ? (K + 15) / 16 * 16 : (K + 127) / 128 * 128;
}

// 1 where the taps product keeps every tap's b resident, 0 where it takes
// the tiled kernel, -1 where the arguments are no shape.
int multi_route(int taps, int N, int K) {
  if (taps <= 0 || N <= 0 || K <= 0) return -1;
  return N <= 128 && resident_b_bytes(N, K) <= RESIDENT_B_MAX / taps ? 1 : 0;
}

template <int NP>
cudaError_t launch_resident(const CUtensorMap& map_a, const byte_t* b,
                            int32_t* out, int M, int N, int K, int taps,
                            size_t smem, cudaStream_t stream) {
  static const cudaError_t allowed = allow_smem(s8_resident_kernel<NP>);
  if (allowed != cudaSuccess) return allowed;
  const int tiles = (M + BM - 1) / BM;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  s8_resident_kernel<NP><<<grid, THREADS, smem, stream>>>(
      map_a, b, out, M, N, K, taps, b_read_mode(b, N), pairs_ok(out, N));
  return cudaGetLastError();
}

// sum over taps of a @ b[t], b [taps, K, N] dense, with every tap's b
// resident; taps = 1 is s8_mm's resident route.
cudaError_t resident(const void* a, const void* b, void* out, int M, int N,
                     int K, int lda, int taps, cudaStream_t stream) {
  if (multi_route(taps, N, K) != 1 || lda < K || !tma_ok(a, lda) ||
      sm_count() <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = R_SMEM_FIXED + taps * resident_b_bytes(N, K);
  CUtensorMap map_a;
  cudaError_t err = make_map(&map_a, 1, a, K, M, lda, ROW_BYTES, BM);
  if (err != cudaSuccess) return err;
  const byte_t* bp = static_cast<const byte_t*>(b);
  int32_t* op = static_cast<int32_t*>(out);
  if (N <= 32) return launch_resident<32>(map_a, bp, op, M, N, K, taps, smem, stream);
  if (N <= 64) return launch_resident<64>(map_a, bp, op, M, N, K, taps, smem, stream);
  return launch_resident<128>(map_a, bp, op, M, N, K, taps, smem, stream);
}

// s8: sum over taps of a @ b[t], b [taps, K, N] dense (ldb == N), through bt
// scratch [N, taps tap_pitch(taps, K)]; bf16: a @ b, taps = 1.
template <int ES>
cudaError_t launch_tiled(const void* a, const void* b, void* bt, void* out,
                         int M, int N, int K, int lda, int ldb, int taps,
                         cudaStream_t stream) {
  typedef typename Acc<ES>::type acc_t;
  constexpr int BK = ROW_BYTES / ES;
  if (!tma_ok(a, static_cast<long long>(lda) * ES) || lda < K || taps <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = make_map(&map_a, ES, a, K, M,
                             static_cast<long long>(lda) * ES, BK, BM);
  if (err != cudaSuccess) return err;
  int kp = 0;
  if constexpr (ES == 1) {
    // b [taps, K, N] dense -> bt [N, taps kp], then loaded like `a`.  The
    // map ends at the last tap's K: past it the TMA unit reads zeros.
    kp = tap_pitch(taps, K);
    const long long ldbt = static_cast<long long>(taps) * kp;
    if (bt == nullptr || ldbt > 0x7fffffff || !tma_ok(bt, ldbt) || ldb != N)
      return cudaErrorInvalidValue;
    const dim3 tgrid((kp + 127) / 128, (N + 63) / 64, taps);
    if (tgrid.y > 65535 || tgrid.z > 65535) return cudaErrorInvalidValue;
    transpose_s8_kernel<<<tgrid, 256, 0, stream>>>(
        static_cast<const byte_t*>(b), static_cast<byte_t*>(bt), K, N,
        static_cast<int>(ldbt), kp, words_ok(b, N));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = make_map(&map_b, ES, bt, static_cast<int>(ldbt - kp) + K, N, ldbt,
                   BK, TN);
  } else {
    if (taps != 1 || !tma_ok(b, static_cast<long long>(ldb) * ES) || ldb < N)
      return cudaErrorInvalidValue;
    err = make_map(&map_b, ES, b, N, K, static_cast<long long>(ldb) * ES, 64,
                   BK);
  }
  if (err != cudaSuccess) return err;
  static const cudaError_t allowed = allow_smem(wgmma_tiled_kernel<ES>);
  if (allowed != cudaSuccess) return allowed;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + TN - 1) / TN;
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  if (tiles > 0x7fffffff || sm_count() <= 0) return cudaErrorInvalidValue;
  const int grid = tiles < sm_count() ? static_cast<int>(tiles) : sm_count();
  wgmma_tiled_kernel<ES><<<grid, THREADS, T_SMEM, stream>>>(
      map_a, map_b, static_cast<acc_t*>(out), M, N, K, tiles_n,
      static_cast<int>(tiles), pairs_ok(out, N), taps, kp);
  return cudaGetLastError();
}

template <int ES, int N>
cudaError_t launch_chained(const CUtensorMap& map_a, const CUtensorMap& map_b,
                           const void* b, void* out, int M, int K, int R,
                           int smem, cudaStream_t stream) {
  static const cudaError_t allowed = allow_smem(chained_dot_kernel<ES, N>);
  if (allowed != cudaSuccess) return allowed;
  chained_dot_kernel<ES, N><<<(M + CD_ROWS - 1) / CD_ROWS, WG_THREADS, smem,
                              stream>>>(map_a, map_b,
                                        static_cast<const byte_t*>(b),
                                        static_cast<typename Acc<ES>::type*>(out),
                                        M, K, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every function launches on `stream`, allocates nothing and returns
// cudaGetLastError() (0 on success).  `a` is row-major with rows `lda`
// elements apart; its base must be 16-byte aligned and its pitch a multiple
// of 16 bytes.  `out` [M, N] is dense.

// The largest K x N the resident kernel takes, as bytes of shared memory for
// b: ceil(K / 128) * 128 * NP with NP = 32, 64 or 128 >= N (for all taps
// together in the taps product).
int az_resident_b_max() { return RESIDENT_B_MAX; }

// Dynamic shared memory of one block: the tiled kernel's, and the resident
// kernel's apart from b.
int az_tiled_smem() { return T_SMEM; }
int az_resident_smem_fixed() { return R_SMEM_FIXED; }

// a s8 [M, K], b s8 [K, N] dense (any alignment), N <= 128, out s32.
int az_s8_mm_resident(const void* a, const void* b, void* out, int M, int N,
                      int K, int lda, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  return resident(a, b, out, M, N, K, lda, 1, static_cast<cudaStream_t>(stream));
}

// elem_size 1: s8 -> s32, b [K, N] dense (ldb == N) and `bt` scratch of
// N x round_up(K, 16) bytes, 16-byte aligned; elem_size 2: bf16 -> f32, b
// rows `ldb` elements apart with a 16-byte aligned base and pitch, bt unused.
int az_wgmma_tiled(const void* a, const void* b, void* bt, void* out, int M,
                   int N, int K, int lda, int ldb, int elem_size, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 1) return launch_tiled<1>(a, b, bt, out, M, N, K, lda, ldb, 1, s);
  if (elem_size == 2) return launch_tiled<2>(a, b, bt, out, M, N, K, lda, ldb, 1, s);
  return cudaErrorInvalidValue;
}

// The route of az_s8_mm_multi: 1 resident (N <= 128 and every tap's b
// within RESIDENT_B_MAX together), 0 tiled, -1 no shape.
int az_s8_mm_multi_route(int taps, int N, int K) { return multi_route(taps, N, K); }

// out s32 [M, N] = sum over taps of a [M, K] @ b[t], a and b s8, b [taps, K,
// N] dense (any alignment).  The tiled route needs `bt` scratch of N x
// (taps * Kp) bytes, 16-byte aligned, Kp = K rounded up to 16 bytes for one
// tap and to 128 for several; the resident route reads no scratch.
int az_s8_mm_multi(const void* a, const void* b, void* bt, void* out, int M,
                   int N, int K, int lda, int taps, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = multi_route(taps, N, K);
  if (route == 1) return resident(a, b, out, M, N, K, lda, taps, s);
  if (route == 0) return launch_tiled<1>(a, b, bt, out, M, N, K, lda, N, taps, s);
  return cudaErrorInvalidValue;
}

// The chained dot's dynamic shared memory a block, or -1 where its kernel
// does not take the shape: elem_size 1 (s8) with N in {32, 64, 128}, or 2
// (bf16) with N in {64, 128}; K a positive multiple of N; b and the band
// within one block's shared memory.
int az_chained_smem(int N, int K, int elem_size) {
  const bool n_ok = N == 64 || N == 128 || (N == 32 && elem_size == 1);
  if ((elem_size != 1 && elem_size != 2) || !n_ok || K <= 0 || K > (1 << 16) ||
      K % N != 0)
    return -1;
  const int total = chain_layout(N, K, elem_size).total;
  return total <= SMEM_MAX ? total : -1;
}

// a [M, K] rows `lda` elements apart (16-byte aligned base and pitch), b
// [K, N] dense with a 16-byte aligned base, out [M, N] dense; shapes as
// az_chained_smem takes them.
int az_chained_dot(const void* a, const void* b, void* out, int M, int N,
                   int K, int lda, int R, int elem_size, void* stream) {
  if (M <= 0) return cudaSuccess;
  const int smem = az_chained_smem(N, K, elem_size);
  const int es = elem_size;
  if (smem < 0 || R < 0 || lda < K ||
      !tma_ok(a, static_cast<long long>(lda) * es) ||
      !tma_ok(b, static_cast<long long>(N) * es))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = make_map(&map_a, es, a, K, M,
                             static_cast<long long>(lda) * es, ROW_BYTES / es,
                             CD_ROWS);
  if (err != cudaSuccess) return err;
  if (es == 2) {
    err = make_map(&map_b, es, b, N, K, static_cast<long long>(N) * es, 64, 64);
    if (err != cudaSuccess) return err;
  } else {
    map_b = map_a;  // not read: s8 b is loaded by the threads
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (es == 1) {
    if (N == 32) return launch_chained<1, 32>(map_a, map_b, b, out, M, K, R, smem, s);
    if (N == 64) return launch_chained<1, 64>(map_a, map_b, b, out, M, K, R, smem, s);
    return launch_chained<1, 128>(map_a, map_b, b, out, M, K, R, smem, s);
  }
  if (N == 64) return launch_chained<2, 64>(map_a, map_b, b, out, M, K, R, smem, s);
  return launch_chained<2, 128>(map_a, map_b, b, out, M, K, R, smem, s);
}

const char* az_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
