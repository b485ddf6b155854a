// s8_mm: integer and bf16 matrix products for Hopper (sm_90a), by hand, on
// mma.sync.
//
// Replaces two Pallas TPU probe kernels of the JAX package (the single
// products, pallas_mm and make_pallas_mm, live in wgmma_mm.cu):
//
//   az_s8_mm_multi  tools/profile_fused_shapes.py::pallas_mm_multi
//                   out = sum_t a @ b[t], s8 -> s32, a [M, K], b [T, K, N]
//   az_chained_dot  tools/profile_inkernel_dot.py::chained_dot
//                   R times a <- tile(requant(a @ b), K / N), then a @ b,
//                   s8 -> s32 or bf16 -> f32, with `a` resident on chip for
//                   all R + 1 products
//
// The TPU kernels walk a sequential grid of row tiles with the whole `b` in
// VMEM.  For the accumulated product a grid of thread blocks covers (M, N)
// tiles of 128 x 64, and each block loops over the taps and over K through a
// three-stage ring of shared-memory tiles filled by cp.async; eight warps
// each own a 32 x 32 patch of the output and run mma.sync (m16n8k32 s8 ->
// s32; the chained dot also m16n8k16 bf16 -> f32).  Any M is taken (rows
// past the edge are zero-filled on load and masked on store); the wrapper
// pads K and N to multiples of 16 elements so that every row starts on a
// 16-byte boundary.
//
// `b` is row-major [K, N], but mma.sync wants, for each output column, four
// (s8) or two (bf16) consecutive K values in one register.  Instead of
// transposing `b` in memory, a thread reads 32-bit words of `b` rows as they
// are (four s8 or two bf16 neighbouring COLUMNS) and transposes 4 x 4 bytes
// (2 x 2 halves) in registers with PRMT.  That hands one thread the
// fragments of several n8 tiles at once, whose columns interleave: the
// column a lane holds in tile j is not 8 j + i but 4 i + j (s8), so the
// tile-to-column map is permuted.  As a side effect each lane ends up with
// 8 (s8) or 4 (bf16) CONSECUTIVE output columns of a row and stores them as
// 16-byte vectors.
//
// What bounds them on the card.  At the probes' shapes ([14400, 128] x
// [5, 128, 64]; 3,600 rows chained through up to 64 products) both move a
// few megabytes at most: the accumulated product is bound by bytes (1.7 us
// at 3.35 TB/s) and in practice by its launch, the chained dot by
// operations, with the chain's dependence and the fragment loads' issue
// slots (8 + 8 32-bit loads and 12 PRMT per 8 mma) well ahead of the tensor
// cores.  Both are kept on this simple, exact template for now.
//
// Integer sums wrap in int32 like the TPU kernels' (no saturation); with
// |values| <= 127 they cannot overflow below K = 133,000.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned char byte_t;

template <int ES> struct Acc;  // ES: bytes per input element
template <> struct Acc<1> { typedef int32_t type; };
template <> struct Acc<2> { typedef float type; };

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

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const byte_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of one 16-row tile for one K step of 32 bytes.  `as` points at
// the tile's first row at the step's byte offset.  In bytes the s8 (k32) and
// bf16 (k16) layouts are the same: lane (g, t) holds rows g and g + 8, bytes
// 4t..4t+3 and 16+4t..16+4t+3.
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
// s8: lane (g, t) reads the words of columns 4g..4g+3 in K rows 4t..4t+3
// (and 16 rows further for the second register) and transposes 4 x 4 bytes;
// tile j then holds column 4g + j.
template <int ES>
__device__ __forceinline__ void load_b(const byte_t* bs, int stride, int col0,
                                       int g, int t, uint32_t (&bf)[4][2]);

template <>
__device__ __forceinline__ void load_b<1>(const byte_t* bs, int stride,
                                          int col0, int g, int t,
                                          uint32_t (&bf)[4][2]) {
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

// bf16: lane (g, t) reads the words of columns 2g, 2g+1 (tiles 0, 1) and
// 16+2g, 16+2g+1 (tiles 2, 3) in K rows 2t, 2t+1 (and 8 rows further) and
// swaps halves; tile j holds column 16 (j / 2) + 2g + j % 2.
template <>
__device__ __forceinline__ void load_b<2>(const byte_t* bs, int stride,
                                          int col0, int g, int t,
                                          uint32_t (&bf)[4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const byte_t* p = bs + (h * 8 + t * 2) * stride + (col0 + g * 2) * 2;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t w0 = ld32(p + q * 32), w1 = ld32(p + stride + q * 32);
      bf[2 * q][h] = __byte_perm(w0, w1, 0x5410);      // low halves
      bf[2 * q + 1][h] = __byte_perm(w0, w1, 0x7632);  // high halves
    }
  }
}

// acc[mt] += A(16-row tile mt) x B(32-column band) over `ksteps` steps of 32
// bytes of K.
template <int ES, int MT>
__device__ __forceinline__ void warp_mma(
    const byte_t* as, int a_stride, const byte_t* bs, int b_stride, int col0,
    int ksteps, int g, int t, typename Acc<ES>::type (&acc)[MT][4][4]) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bf[4][2];
    load_b<ES>(bs + ks * (32 / ES) * b_stride, b_stride, col0, g, t, bf);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t af[4];
      load_a(as + mt * 16 * a_stride + ks * 32, a_stride, g, t, af);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[mt][j], af, bf[j]);
    }
  }
}

// The accumulators of one 16 x 32 patch, regrouped as the consecutive
// columns each lane holds.  Row half r (rows g + 8r); s8: v[0..7] are band
// columns 8t..8t+7; bf16: v[0..3] are 4t..4t+3 and v[4..7] are 16+4t..16+4t+3.
template <int ES, typename T>
__device__ __forceinline__ void lane_columns(const T (&acc)[4][4], int r,
                                             T (&v)[8]) {
  if constexpr (ES == 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[e * 4 + j] = acc[j][r * 2 + e];
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[q * 4 + e * 2 + j] = acc[q * 2 + j][r * 2 + e];
  }
}

// Band column of v[0] and of v[4] for lane t.
template <int ES> __device__ __forceinline__ int lane_col(int t, int half) {
  return ES == 1 ? 8 * t + 4 * half : 16 * half + 4 * t;
}

// Store one 16 x 32 patch to row-major out [M, N] (N a multiple of 4) as
// 16-byte vectors, masking rows >= M and columns >= N.
template <int ES, typename T>
__device__ __forceinline__ void store_patch(T* out, int M, int N, int row0,
                                            int col0, int g, int t,
                                            const T (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= M) continue;
    T v[8];
    lane_columns<ES>(acc, r, v);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + lane_col<ES>(t, half);
      if (col >= N) continue;
      uint4 w;
      w.x = *reinterpret_cast<const uint32_t*>(&v[half * 4 + 0]);
      w.y = *reinterpret_cast<const uint32_t*>(&v[half * 4 + 1]);
      w.z = *reinterpret_cast<const uint32_t*>(&v[half * 4 + 2]);
      w.w = *reinterpret_cast<const uint32_t*>(&v[half * 4 + 3]);
      *reinterpret_cast<uint4*>(out + (long long)row * N + col) = w;
    }
  }
}

// ------------------------------------------------- row-tiled, over taps

constexpr int BM = 128, BN = 64, BKB = 64, STAGES = 3, THREADS = 256;
constexpr int A_STRIDE = BKB + 16;  // +16 bytes: conflict-free fragment reads

// out [M, N] = sum over taps of a [M, K] @ b[tap] [K, N].
template <int ES>
__global__ void __launch_bounds__(THREADS)
tiled_mm_kernel(const byte_t* __restrict__ a, const byte_t* __restrict__ b,
                typename Acc<ES>::type* __restrict__ out, int M, int N, int K,
                int taps) {
  typedef typename Acc<ES>::type acc_t;
  constexpr int BK = BKB / ES;  // K rows of b per stage
  constexpr int B_STRIDE = BN * ES + 16;
  __shared__ __align__(16) byte_t As[STAGES][BM * A_STRIDE];
  __shared__ __align__(16) byte_t Bs[STAGES][BK * B_STRIDE];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long kbytes = (long long)K * ES, nbytes = (long long)N * ES;
  const int ktiles = (K + BK - 1) / BK;
  const int total = taps * ktiles;

  auto load_stage = [&](int stage, int it) {
    const int tap = it / ktiles, kk = it - tap * ktiles;
    for (int c = tid; c < BM * (BKB / 16); c += THREADS) {
      const int row = c >> 2, ch = c & 3;
      const long long kb = (long long)kk * BKB + ch * 16;
      const bool ok = m0 + row < M && kb < kbytes;
      const byte_t* src = ok ? a + (long long)(m0 + row) * kbytes + kb : a;
      cp_async16(&As[stage][row * A_STRIDE + ch * 16], src, ok ? 16 : 0);
    }
    constexpr int CH = BN * ES / 16;
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, ch = c % CH;
      const int k = kk * BK + r;
      const long long nb = (long long)n0 * ES + ch * 16;
      const bool ok = k < K && nb < nbytes;
      const byte_t* src = ok ? b + ((long long)tap * K + k) * nbytes + nb : b;
      cp_async16(&Bs[stage][r * B_STRIDE + ch * 16], src, ok ? 16 : 0);
    }
  };

  acc_t acc[2][4][4];
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
    warp_mma<ES, 2>(&As[stage][wm * 32 * A_STRIDE], A_STRIDE, Bs[stage],
                    B_STRIDE, wn * 32, BKB / 32, g, t, acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    store_patch<ES>(out, M, N, m0 + wm * 32 + mt * 16, n0 + wn * 32, g, t,
                    acc[mt]);
}

template <int ES>
cudaError_t launch_tiled(const void* a, const void* b, void* out, int M, int N,
                         int K, int taps, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if ((K * ES) % 16 != 0 || (N * ES) % 16 != 0 || N % 4 != 0 || K <= 0 ||
      taps <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  tiled_mm_kernel<ES><<<grid, THREADS, 0, stream>>>(
      static_cast<const byte_t*>(a), static_cast<const byte_t*>(b),
      static_cast<typename Acc<ES>::type*>(out), M, N, K, taps);
  return cudaGetLastError();
}

// ------------------------------------------------------------- chained dot

constexpr int CD_ROWS = 64, CD_THREADS = 128;  // 4 warps x 16 rows

__device__ __forceinline__ int32_t requant(int32_t acc) {
  return (int32_t)(int8_t)(acc >> 8);  // arithmetic shift, wrapping cast
}

// One block keeps a band of 64 rows of `a` and the whole of `b` in shared
// memory for all R + 1 products; rows do not interact, so every warp owns 16
// rows and only warp-level synchronisation separates the steps.  `a` has two
// buffers: a step reads one and writes the requantised, column-tiled result
// into the other.
template <int ES>
__global__ void __launch_bounds__(CD_THREADS)
chained_dot_kernel(const byte_t* __restrict__ a, const byte_t* __restrict__ b,
                   typename Acc<ES>::type* __restrict__ out, int M, int N,
                   int K, int R) {
  typedef typename Acc<ES>::type acc_t;
  extern __shared__ __align__(16) byte_t smem[];
  const int kbytes = K * ES, nbytes = N * ES;
  const int a_stride = kbytes + 16, b_stride = nbytes + 16;
  byte_t* Bs = smem;
  byte_t* cur = Bs + (size_t)K * b_stride;
  byte_t* nxt = cur + (size_t)CD_ROWS * a_stride;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * CD_ROWS;

  for (int c = tid; c < K * (nbytes / 16); c += CD_THREADS) {
    const int r = c / (nbytes / 16), ch = c % (nbytes / 16);
    *reinterpret_cast<uint4*>(Bs + r * b_stride + ch * 16) =
        *reinterpret_cast<const uint4*>(b + (long long)r * nbytes + ch * 16);
  }
  for (int c = tid; c < CD_ROWS * (kbytes / 16); c += CD_THREADS) {
    const int r = c / (kbytes / 16), ch = c % (kbytes / 16);
    uint4 w = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      w = *reinterpret_cast<const uint4*>(a + (long long)(m0 + r) * kbytes +
                                          ch * 16);
    *reinterpret_cast<uint4*>(cur + r * a_stride + ch * 16) = w;
  }
  __syncthreads();

  const int reps = K / N;
  for (int step = 0; step <= R; ++step) {
    for (int nb = 0; nb < N / 32; ++nb) {
      acc_t acc[1][4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][j][e] = 0;
      warp_mma<ES, 1>(cur + warp * 16 * a_stride, a_stride, Bs, b_stride,
                      nb * 32, kbytes / 32, g, t, acc);
      if (step == R) {
        store_patch<ES>(out, M, N, m0 + warp * 16, nb * 32, g, t, acc[0]);
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc_t v[8];
        lane_columns<ES>(acc[0], r, v);
        byte_t* row = nxt + (warp * 16 + g + 8 * r) * a_stride;
        if constexpr (ES == 1) {
          // 8 consecutive s8 columns 8t..8t+7 of the band: one 8-byte store.
          uint2 w;
          w.x = (requant(v[0]) & 0xff) | ((requant(v[1]) & 0xff) << 8) |
                ((requant(v[2]) & 0xff) << 16) | ((uint32_t)requant(v[3]) << 24);
          w.y = (requant(v[4]) & 0xff) | ((requant(v[5]) & 0xff) << 8) |
                ((requant(v[6]) & 0xff) << 16) | ((uint32_t)requant(v[7]) << 24);
          for (int rep = 0; rep < reps; ++rep)
            *reinterpret_cast<uint2*>(row + rep * N + nb * 32 + 8 * t) = w;
        } else {
          // 4 + 4 consecutive bf16 columns: two 8-byte stores.
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(
                (float)v[half * 4 + 0] * 0.001f, (float)v[half * 4 + 1] * 0.001f);
            __nv_bfloat162 hi = __floats2bfloat162_rn(
                (float)v[half * 4 + 2] * 0.001f, (float)v[half * 4 + 3] * 0.001f);
            uint2 w;
            w.x = *reinterpret_cast<uint32_t*>(&lo);
            w.y = *reinterpret_cast<uint32_t*>(&hi);
            const int col = nb * 32 + lane_col<ES>(t, half);
            for (int rep = 0; rep < reps; ++rep)
              *reinterpret_cast<uint2*>(row + (rep * N + col) * 2) = w;
          }
        }
      }
    }
    __syncwarp();
    byte_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <int ES>
cudaError_t launch_chained(const void* a, const void* b, void* out, int M, int N,
                           int K, int R, cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  if (N <= 0 || K <= 0 || R < 0 || N % 32 != 0 || K % N != 0 ||
      (K * ES) % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)K * (N * ES + 16) +
                      2 * (size_t)CD_ROWS * (K * ES + 16);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      chained_dot_kernel<ES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  chained_dot_kernel<ES><<<(M + CD_ROWS - 1) / CD_ROWS, CD_THREADS, smem,
                           stream>>>(
      static_cast<const byte_t*>(a), static_cast<const byte_t*>(b),
      static_cast<typename Acc<ES>::type*>(out), M, N, K, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors contiguous on the current device with 16-byte aligned bases;
// K and N multiples of 16.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success).

// a s8 [M, K], b s8 [taps, K, N], out s32 [M, N].
int az_s8_mm_multi(const void* a, const void* b, void* out, int M, int N, int K,
                   int taps, void* stream) {
  return launch_tiled<1>(a, b, out, M, N, K, taps,
                         static_cast<cudaStream_t>(stream));
}

// a [M, K], b [K, N], out [M, N]; N a multiple of 32, K a multiple of N;
// elem_size 1: s8 -> s32; elem_size 2: bf16 -> f32.
int az_chained_dot(const void* a, const void* b, void* out, int M, int N, int K,
                   int R, int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 1) return launch_chained<1>(a, b, out, M, N, K, R, s);
  if (elem_size == 2) return launch_chained<2>(a, b, out, M, N, K, R, s);
  return cudaErrorInvalidValue;
}

const char* az_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
