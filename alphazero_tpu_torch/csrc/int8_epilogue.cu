// int8_epilogue: the epilogue of each 3x3 trunk conv of the int8 executor
// (alphazero_tpu_torch/models/quant.py forward_int8_from_q) in one pass, for
// Hopper (sm_90a).
//
// It replaces no TPU kernel.  The JAX package's int8 trunk
// (alphazero_tpu/models/quant.py forward_int8_from_q) leaves the epilogue to
// XLA, which fuses it into the convolution.  Eager PyTorch ran it as 6 to 15
// separate passes over the [B*H*W, O] s32 product of each conv: the requant
// (a multiply, an add), the quantiser (a multiply, round, clamp, a cast),
// after conv2 the bf16 cast, the int8 residual's dequantisation, the SE
// scale, the add and the ReLU, and before conv2 the tap sums of the SE gate
// (about 9 launches).  Each pass cost the host a launch and the device a
// full read and write of the tensor.
//
// The kernel takes the s32 accumulator that s8_mm returns and writes what
// the next product reads, in one of three forms:
//   STEM   a = bf16(relu(acc * m + bias)); q = quantise(a); a kept on demand
//   CONV1  q = quantise(acc * m + bias) with the ReLU in the clip (lo = 0),
//          and the [B, 9, O] i32 tap sums of q that the SE gate contracts
//   CONV2  h2 = bf16(acc * m + bias); r = the residual (the bf16 master copy,
//          or bf16(aq) * bf16(s_prev / 127) from the s8 carry);
//          a = relu(bf16(r + bf16(h2 * g))); q = quantise(a); a on demand
// where quantise(x) = clamp(round_half_even(x * qmul), lo, 127) and qmul is
// 127 / scale exactly as the executor computes it (a tensor the host
// passes, never recomputed here).
//
// Bit for bit the plain passes of quant.py on the card: the s32 -> f32
// conversion is round-to-nearest, every f32 multiply and add is rounded on
// its own (__fmul_rn / __fadd_rn: nothing is contracted into an FMA), each
// bf16 operation rounds its f32 result to bf16 (round to nearest even), as
// PyTorch's bf16 kernels do through their f32 opmath, and rintf rounds half
// to even as torch.round does.  Products of two bf16 values, or of an s8
// value and a bf16 one, are exact in f32, so those round once, to bf16.
//
// What bounds it: bytes (a few operations an element).  Per element it
// reads the 4-byte accumulator, plus the residual (1 or 2 bytes) in CONV2,
// and writes the s8 result, plus 2 bytes where the bf16 copy is kept.  One
// block takes one board, so the per-board tap sums need no atomics and the
// per-board SE gate is loaded once a thread.  A thread owns 4 channels: it
// reads 16 bytes of the accumulator, and neighbouring threads read
// neighbouring words, a row of O channels by O / 4 threads; the block's
// other threads take further cells of the board.  CONV1 keeps per thread
// the nine border sums of its channels from which the taps follow by
// inclusion-exclusion, and reduces them across the block in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHANNELS = 4 * THREADS;  // one 4-channel group a thread
constexpr int SUMS = 9;  // all, first row, last row, first column, last
                         // column, and the four corners

enum Form : int { STEM = 0, CONV1 = 1, CONV2 = 2 };

struct Params {
  const int4* acc;     // [B * P, O] s32 in groups of 4 channels
  const float4* m;     // [O] requant multipliers
  const float4* bias;  // [O]
  const float* qmul;   // [1] 127 / scale of the output's quantiser
  uint32_t* out_q;     // [B * P, O] s8, 4 channels a word
  uint2* out_a;        // [B * P, O] bf16, 4 channels a word pair, or null
  int* taps;           // CONV1: [B, 9, O] i32
  const uint2* gate;   // CONV2: [B, O] bf16 SE gate
  const uint2* res_a;  // CONV2: [B * P, O] bf16 residual, or null
  const uint32_t* res_q;           // CONV2: [B * P, O] s8 residual, or null
  const __nv_bfloat16* res_scale;  // CONV2 with res_q: [1] its bf16 scale
  int H, W, groups;                // groups = O / 4
};

// x rounded to bf16 (nearest, ties to even), as a float.
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bf16 bits of a float that already holds a bf16 value.
__device__ __forceinline__ uint32_t bf_bits(float x) {
  return __float_as_uint(x) >> 16;
}

__device__ __forceinline__ void unpack_bf16(uint2 u, float f[4]) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

// clamp(round(x * qmul), lo, 127) as an integer.
__device__ __forceinline__ int quantise(float x, float qmul, float lo) {
  const float v = rintf(__fmul_rn(x, qmul));
  return static_cast<int>(fminf(fmaxf(v, lo), 127.0f));
}

// CONV1's taps of board b from each thread's nine border sums of its four
// channels.  The block's sums, [slot][sum][channel], are summed over the
// slots into slot 0: index i of slot 0 is written only by the thread that
// reads index i of every slot.
__device__ __forceinline__ void reduce_taps(const Params& p, const int (&sums)[SUMS][4],
                                            int slot, int slots, int g, long long b) {
  __shared__ int red[SUMS * MAX_CHANNELS];
  const int O = 4 * p.groups, n = SUMS * O;
#pragma unroll
  for (int t = 0; t < SUMS; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) red[(slot * SUMS + t) * O + 4 * g + k] = sums[t][k];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int v = 0;
    for (int sl = 0; sl < slots; ++sl) v += red[sl * n + i];
    red[i] = v;
  }
  __syncthreads();
  // Tap (ky, kx) sums every cell but the input row that ky = 0 (the last)
  // or ky = 2 (the first) never reads, and likewise the column of kx: all,
  // less that row and that column, plus the corner they share.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int tap = i / O, c = i - tap * O, ky = tap / 3, kx = tap - 3 * ky;
    const int* r = red + c;
    int v = r[0];
    if (ky != 1) v -= r[(ky == 0 ? 2 : 1) * O];
    if (kx != 1) v -= r[(kx == 0 ? 4 : 3) * O];
    if (ky != 1 && kx != 1) v += r[(ky == 0 ? (kx == 0 ? 8 : 7) : (kx == 0 ? 6 : 5)) * O];
    p.taps[(b * 9 + tap) * O + c] = v;
  }
}

template <int F>
__global__ void __launch_bounds__(THREADS) epilogue_kernel(const Params p) {
  const int4* __restrict__ acc = p.acc;
  uint32_t* __restrict__ out_q = p.out_q;
  uint2* __restrict__ out_a = p.out_a;
  const int groups = p.groups, slots = blockDim.x / groups;
  const int g = threadIdx.x % groups, slot = threadIdx.x / groups;
  const int P = p.H * p.W;
  const long long b = blockIdx.x;
  const float4 m4 = p.m[g], b4 = p.bias[g];
  const float m[4] = {m4.x, m4.y, m4.z, m4.w};
  const float bias[4] = {b4.x, b4.y, b4.z, b4.w};
  const float qmul = *p.qmul;
  float gate[4] = {0.f, 0.f, 0.f, 0.f}, rs = 0.f;
  if constexpr (F == CONV2) {
    unpack_bf16(p.gate[b * groups + g], gate);
    if (p.res_q != nullptr) rs = __bfloat162float(*p.res_scale);
  }
  int sums[SUMS][4] = {};

#pragma unroll 4
  for (int cell = slot; cell < P; cell += slots) {
    const long long e = (b * P + cell) * groups + g;
    const int4 s = acc[e];
    const int si[4] = {s.x, s.y, s.z, s.w};
    int q[4];
    float a[4];
    if constexpr (F == CONV2) {
      float r[4];
      if (p.res_q != nullptr) {
        const uint32_t w = p.res_q[e];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          r[k] = bf(__fmul_rn(static_cast<float>(static_cast<int8_t>(w >> (8 * k))), rs));
      } else {
        unpack_bf16(p.res_a[e], r);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float h2 = bf(__fadd_rn(__fmul_rn(__int2float_rn(si[k]), m[k]), bias[k]));
        const float x = bf(__fadd_rn(r[k], bf(__fmul_rn(h2, gate[k]))));
        a[k] = x > 0.f ? x : 0.f;
        q[k] = quantise(a[k], qmul, -127.f);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float y = __fadd_rn(__fmul_rn(__int2float_rn(si[k]), m[k]), bias[k]);
        if constexpr (F == STEM) {
          a[k] = bf(y > 0.f ? y : 0.f);
          q[k] = quantise(a[k], qmul, -127.f);
        } else {
          q[k] = quantise(y, qmul, 0.f);
        }
      }
    }
    out_q[e] = (q[0] & 0xff) | (q[1] & 0xff) << 8 | (q[2] & 0xff) << 16 |
               static_cast<uint32_t>(q[3] & 0xff) << 24;
    if constexpr (F != CONV1) {
      if (out_a != nullptr)
        out_a[e] = make_uint2(bf_bits(a[0]) | bf_bits(a[1]) << 16,
                              bf_bits(a[2]) | bf_bits(a[3]) << 16);
    } else {
      const int i = cell / p.W, j = cell - i * p.W;
      const bool r0 = i == 0, rl = i == p.H - 1, c0 = j == 0, cl = j == p.W - 1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = q[k];
        sums[0][k] += v;
        sums[1][k] += r0 ? v : 0;
        sums[2][k] += rl ? v : 0;
        sums[3][k] += c0 ? v : 0;
        sums[4][k] += cl ? v : 0;
        sums[5][k] += r0 && c0 ? v : 0;
        sums[6][k] += r0 && cl ? v : 0;
        sums[7][k] += rl && c0 ? v : 0;
        sums[8][k] += rl && cl ? v : 0;
      }
    }
  }
  if constexpr (F == CONV1) reduce_taps(p, sums, slot, slots, g, b);
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// form 0 (stem), 1 (conv1) or 2 (conv2) over an accumulator [B, H, W, O],
// O a multiple of 4 from 4 to MAX_CHANNELS, every tensor contiguous on the
// current device; out_a, taps, gate, res_a,
// res_q and res_scale may be null where the form does not use them (see
// Params).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int az_int8_epilogue(int form, const void* acc, const void* m, const void* bias,
                     const void* qmul, void* out_q, void* out_a, void* taps,
                     const void* gate, const void* res_a, const void* res_q,
                     const void* res_scale, long long B, long long H,
                     long long W, long long O, void* stream) {
  if (O % 4 != 0 || O < 4 || O > MAX_CHANNELS || B < 0 || H < 1 || W < 1 ||
      B >= (1ll << 31) || H * W >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (!(aligned(acc, 16) && aligned(m, 16) && aligned(bias, 16) &&
        aligned(out_q, 4) && aligned(out_a, 8) && aligned(taps, 4) &&
        aligned(gate, 8) && aligned(res_a, 8) && aligned(res_q, 4)) ||
      acc == nullptr || m == nullptr || bias == nullptr || qmul == nullptr ||
      out_q == nullptr)
    return cudaErrorInvalidValue;
  if (form == CONV1 && taps == nullptr) return cudaErrorInvalidValue;
  if (form == CONV2 && (gate == nullptr || (res_a == nullptr) == (res_q == nullptr) ||
                        (res_q != nullptr && res_scale == nullptr)))
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p{};
  p.acc = static_cast<const int4*>(acc);
  p.m = static_cast<const float4*>(m);
  p.bias = static_cast<const float4*>(bias);
  p.qmul = static_cast<const float*>(qmul);
  p.out_q = static_cast<uint32_t*>(out_q);
  p.out_a = static_cast<uint2*>(out_a);
  p.taps = static_cast<int*>(taps);
  p.gate = static_cast<const uint2*>(gate);
  p.res_a = static_cast<const uint2*>(res_a);
  p.res_q = static_cast<const uint32_t*>(res_q);
  p.res_scale = static_cast<const __nv_bfloat16*>(res_scale);
  p.H = static_cast<int>(H);
  p.W = static_cast<int>(W);
  p.groups = static_cast<int>(O / 4);
  const unsigned threads = (THREADS / p.groups) * p.groups;
  const unsigned blocks = static_cast<unsigned>(B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case STEM: epilogue_kernel<STEM><<<blocks, threads, 0, s>>>(p); break;
    case CONV1: epilogue_kernel<CONV1><<<blocks, threads, 0, s>>>(p); break;
    case CONV2: epilogue_kernel<CONV2><<<blocks, threads, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* az_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
