// s8_mm: the accumulated integer product for Hopper (sm_90a), by hand, on
// mma.sync.
//
// Replaces one Pallas TPU probe kernel of the JAX package (the single
// products pallas_mm and make_pallas_mm, and the chained dot, live in
// wgmma_mm.cu):
//
//   az_s8_mm_multi  tools/profile_fused_shapes.py::pallas_mm_multi
//                   out = sum_t a @ b[t], s8 -> s32, a [M, K], b [T, K, N]
//
// The TPU kernel walks a sequential grid of row tiles with the whole `b` in
// VMEM.  Here a grid of thread blocks covers (M, N) tiles of 128 x 64, and
// each block loops over the taps and over K through a three-stage ring of
// shared-memory tiles filled by cp.async; eight warps each own a 32 x 32
// patch of the output and run mma.sync m16n8k32 s8 -> s32.  Any M is taken
// (rows past the edge are zero-filled on load and masked on store); the
// wrapper pads K and N to multiples of 16 so that every row starts on a
// 16-byte boundary.
//
// `b` is row-major [K, N], but mma.sync wants, for each output column, four
// consecutive K values in one register.  Instead of transposing `b` in
// memory, a thread reads 32-bit words of `b` rows as they are (four
// neighbouring COLUMNS) and transposes 4 x 4 bytes in registers with PRMT.
// That hands one thread the fragments of several n8 tiles at once, whose
// columns interleave: the column a lane holds in tile j is not 8 j + i but
// 4 i + j, so the tile-to-column map is permuted.  As a side effect each lane
// ends up with 8 CONSECUTIVE output columns of a row and stores them as
// 16-byte vectors.
//
// What bounds it on the card.  At the probe's shape ([14400, 128] x
// [5, 128, 64]) it moves a few megabytes: bound by bytes (1.7 us at
// 3.35 TB/s) and in practice by its launch and the fragment loads' issue
// slots (8 + 8 32-bit loads and 12 PRMT per 8 mma).  It is kept on this
// simple, exact template for now.
//
// Integer sums wrap in int32 like the TPU kernel's (no saturation); with
// |values| <= 127 they cannot overflow below K = 133,000.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned char byte_t;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  // Copies src_bytes (0 or 16) and fills the rest of the 16 bytes with zeros.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma(int32_t (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const byte_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of one 16-row tile for one K step of 32 bytes.  `as` points at
// the tile's first row at the step's byte offset: lane (g, t) holds rows g
// and g + 8, bytes 4t..4t+3 and 16+4t..16+4t+3.
__device__ __forceinline__ void load_a(const byte_t* as, int stride, int g,
                                       int t, uint32_t (&a)[4]) {
  const byte_t* p = as + g * stride + t * 4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * stride + 16);
}

// B fragments of four n8 tiles (a band of 32 columns starting at col0) for
// one K step.  `bs` points at the step's first K row of the row-major tile.
// Lane (g, t) reads the words of columns 4g..4g+3 in K rows 4t..4t+3 (and 16
// rows further for the second register) and transposes 4 x 4 bytes; tile j
// then holds column 4g + j.
__device__ __forceinline__ void load_b(const byte_t* bs, int stride, int col0,
                                       int g, int t, uint32_t (&bf)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const byte_t* p = bs + (h * 16 + t * 4) * stride + col0 + g * 4;
    const uint32_t w0 = ld32(p), w1 = ld32(p + stride);
    const uint32_t w2 = ld32(p + 2 * stride), w3 = ld32(p + 3 * stride);
    const uint32_t x0 = __byte_perm(w0, w1, 0x5140);  // w0.0 w1.0 w0.1 w1.1
    const uint32_t x1 = __byte_perm(w2, w3, 0x5140);
    const uint32_t y0 = __byte_perm(w0, w1, 0x7362);  // w0.2 w1.2 w0.3 w1.3
    const uint32_t y1 = __byte_perm(w2, w3, 0x7362);
    bf[0][h] = __byte_perm(x0, x1, 0x5410);
    bf[1][h] = __byte_perm(x0, x1, 0x7632);
    bf[2][h] = __byte_perm(y0, y1, 0x5410);
    bf[3][h] = __byte_perm(y0, y1, 0x7632);
  }
}

// acc[mt] += A(16-row tile mt) x B(32-column band) over `ksteps` steps of 32
// bytes of K.
template <int MT>
__device__ __forceinline__ void warp_mma(const byte_t* as, int a_stride,
                                         const byte_t* bs, int b_stride,
                                         int col0, int ksteps, int g, int t,
                                         int32_t (&acc)[MT][4][4]) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bf[4][2];
    load_b(bs + ks * 32 * b_stride, b_stride, col0, g, t, bf);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t af[4];
      load_a(as + mt * 16 * a_stride + ks * 32, a_stride, g, t, af);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[mt][j], af, bf[j]);
    }
  }
}

// Store one 16 x 32 patch to row-major out [M, N] (N a multiple of 4) as
// 16-byte vectors, masking rows >= M and columns >= N.  Row half r (rows
// g + 8r) of lane t holds band columns 8t..8t+7: acc[j][2r + e] is column
// 8t + 4e + j.
__device__ __forceinline__ void store_patch(int32_t* out, int M, int N,
                                            int row0, int col0, int g, int t,
                                            const int32_t (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= M) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * t + 4 * e;
      if (col >= N) continue;
      const uint4 w = make_uint4(acc[0][2 * r + e], acc[1][2 * r + e],
                                 acc[2][2 * r + e], acc[3][2 * r + e]);
      *reinterpret_cast<uint4*>(out + (long long)row * N + col) = w;
    }
  }
}

// ------------------------------------------------- row-tiled, over taps

constexpr int BM = 128, BN = 64, BK = 64, STAGES = 3, THREADS = 256;
constexpr int A_STRIDE = BK + 16;  // +16 bytes: conflict-free fragment reads
constexpr int B_STRIDE = BN + 16;

// out [M, N] = sum over taps of a [M, K] @ b[tap] [K, N].
__global__ void __launch_bounds__(THREADS)
multi_mm_kernel(const byte_t* __restrict__ a, const byte_t* __restrict__ b,
                int32_t* __restrict__ out, int M, int N, int K, int taps) {
  __shared__ __align__(16) byte_t As[STAGES][BM * A_STRIDE];
  __shared__ __align__(16) byte_t Bs[STAGES][BK * B_STRIDE];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int total = taps * ktiles;

  auto load_stage = [&](int stage, int it) {
    const int tap = it / ktiles, kk = it - tap * ktiles;
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int row = c >> 2, ch = c & 3;
      const long long kb = (long long)kk * BK + ch * 16;
      const bool ok = m0 + row < M && kb < K;
      const byte_t* src = ok ? a + (long long)(m0 + row) * K + kb : a;
      cp_async16(&As[stage][row * A_STRIDE + ch * 16], src, ok ? 16 : 0);
    }
    constexpr int CH = BN / 16;
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, ch = c % CH;
      const int k = kk * BK + r;
      const long long nb = (long long)n0 + ch * 16;
      const bool ok = k < K && nb < N;
      const byte_t* src = ok ? b + ((long long)tap * K + k) * N + nb : b;
      cp_async16(&Bs[stage][r * B_STRIDE + ch * 16], src, ok ? 16 : 0);
    }
  };

  int32_t acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();  // stage `it` has landed
    __syncthreads();              // and everyone is done with stage it - 1
    const int next = it + STAGES - 1;
    if (next < total) load_stage(next % STAGES, next);
    cp_async_commit();
    const int stage = it % STAGES;
    warp_mma<2>(&As[stage][wm * 32 * A_STRIDE], A_STRIDE, Bs[stage], B_STRIDE,
                wn * 32, BK / 32, g, t, acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    store_patch(out, M, N, m0 + wm * 32 + mt * 16, n0 + wn * 32, g, t, acc[mt]);
}

}  // namespace

extern "C" {

// a s8 [M, K], b s8 [taps, K, N], out s32 [M, N]; all contiguous on the
// current device with 16-byte aligned bases, K and N multiples of 16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int az_s8_mm_multi(const void* a, const void* b, void* out, int M, int N, int K,
                   int taps, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K % 16 != 0 || N % 16 != 0 || K <= 0 || taps <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  multi_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const byte_t*>(a), static_cast<const byte_t*>(b),
      static_cast<int32_t*>(out), M, N, K, taps);
  return cudaGetLastError();
}

const char* az_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
