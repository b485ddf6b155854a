// se_gate: the squeeze-and-excitation gate of each int8 trunk block
// (alphazero_tpu_torch/models/quant.py forward_int8_from_q) in one launch,
// for Hopper (sm_90a).
//
// It replaces no TPU kernel.  The JAX package computes the gate from the
// tap sums of conv2's input (alphazero_tpu/models/quant.py
// _se_gate_precomputed) and leaves its small ops to XLA, which fuses them.
// Eager PyTorch ran it as 12 launches a block (quant.py _se_gate_from_taps):
// the f32 contraction of the tap sums with conv2's weight, the multiply by
// m, the division by the board's cells, the bias add, the bf16 cast, and the
// SE MLP's two bf16 products, two bias adds, ReLU and sigmoid.  Each launch
// cost the host more time than the device spent on it.
//
// For each board, from the [9C] i32 tap sums T of conv2's s8 input (written
// by int8_epilogue's CONV1 form) to the [O] bf16 gate that int8_epilogue's
// CONV2 form reads:
//   s[o]    = sum_k T[k] * W[k, o]            W: conv2's s8 weight [9C, O]
//   mean[o] = bf16(f32(s[o]) * m[o] * (1 / hw) + bias[o])
//   h[j]    = relu(bf16(bf16(sum_o mean[o] * W1[o, j]) + b1[j]))
//   z[o]    = bf16(bf16(sum_j h[j] * W2[j, o]) + b2[o])
//   gate[o] = bf16(1 / (1 + exp(-z[o])))
// rounded where the plain chain on the card rounds, in no fewer bits:
//   - the contraction is exact: integer products summed in double (every
//     partial sum is an integer below 2**50), rounded once to f32.  The
//     plain chain's f32 product rounds each partial sum, so the two agree
//     to within its rounding;
//   - each f32 multiply and add is rounded on its own (__fmul_rn /
//     __fadd_rn: nothing is contracted into an FMA).  PyTorch divides a
//     CUDA tensor by a Python number as a multiply by the f32 reciprocal,
//     which the host computes here the same way;
//   - each product of the MLP sums exact bf16 x bf16 products in f32 and
//     rounds to bf16 once, as cuBLAS does with its f32 accumulator (in
//     another order, so the two agree to within a bf16 ulp); each bias add
//     rounds its f32 sum to bf16, as PyTorch's bf16 add does;
//   - the sigmoid is PyTorch's: 1 / (1 + expf(-z)) in f32 (expf, not the
//     fast __expf; an IEEE division), rounded to bf16.
//
// What bounds it: latency.  A Gomoku chunk (512 boards, C = O = 64, 16
// hidden) is 19 M multiply-adds of the contraction and 2.4 MB of tap sums
// and gates, microseconds of the card's peaks.  So one launch does it all:
// a block takes BOARDS boards, stages their tap sums (as doubles) and the
// MLP's weights in shared memory once, splits the contraction's 9C terms
// over the block's threads (a thread owns 4 output channels of every board
// and a slice of the terms, reading 4 weights a load), and sums the slices
// in shared memory.  The MLP then runs from shared memory, one output a
// thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BOARDS = 4;         // boards a block
constexpr int MAX_WIDTH = 256;    // C and O
constexpr int MAX_HIDDEN = 128;
constexpr int STATIC_SMEM = 48 * 1024;  // above it, only after an opt-in

struct Params {
  const int* taps;              // [B, 9C] i32
  const uint32_t* w;            // [9C, O] s8, 4 channels a word
  const float* m;               // [O]
  const float* bias;            // [O]
  const uint32_t* w1;           // [O, hidden] bf16, 2 a word
  const __nv_bfloat16* b1;      // [hidden]
  const uint32_t* w2;           // [hidden, O] bf16, 2 a word
  const __nv_bfloat16* b2;      // [O]
  __nv_bfloat16* gate;          // [B, O]
  float inv_hw;
  int B, K, O, hidden;          // K = 9C
};

// x rounded to bf16 (nearest, ties to even), as a float.
__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf_at(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// Shared memory of a block, in bytes: the tap sums as doubles, which the
// contraction's partial sums reuse; the MLP's weights in bf16; the bf16
// means and the hidden layer, as floats.
__host__ __device__ inline size_t taps_bytes(int K, int O) {
  const int groups = O / 4, slices = THREADS / groups;
  const size_t t = sizeof(double) * BOARDS * K;
  const size_t part = sizeof(double) * slices * BOARDS * O;
  return t > part ? t : part;
}

__host__ __device__ inline size_t smem_bytes(int K, int O, int hidden) {
  return taps_bytes(K, O) + 2 * sizeof(__nv_bfloat16) * O * hidden +
         sizeof(float) * BOARDS * (O + hidden);
}

__global__ void __launch_bounds__(THREADS) se_gate_kernel(const Params p) {
  extern __shared__ double smem[];
  const int K = p.K, O = p.O, hidden = p.hidden;
  double* taps = smem;  // [BOARDS][K], then the partial sums
  __nv_bfloat16* w1 = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(smem) + taps_bytes(K, O));
  __nv_bfloat16* w2 = w1 + O * hidden;
  float* mean = reinterpret_cast<float*>(w2 + O * hidden);  // [BOARDS][O]
  float* hid = mean + BOARDS * O;                           // [BOARDS][hidden]

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * BOARDS;
  const int nb = static_cast<int>(p.B - b0 < BOARDS ? p.B - b0 : BOARDS);

  // Stage: the tap sums of the block's boards (zeros past the last board)
  // and the MLP's weights, two bf16 values a word.
  for (int i = tid; i < BOARDS * K; i += nt)
    taps[i] = i < nb * K ? static_cast<double>(p.taps[b0 * K + i]) : 0.0;
  uint32_t* w1w = reinterpret_cast<uint32_t*>(w1);
  uint32_t* w2w = reinterpret_cast<uint32_t*>(w2);
  for (int i = tid; i < O * hidden / 2; i += nt) {
    w1w[i] = p.w1[i];
    w2w[i] = p.w2[i];
  }
  __syncthreads();

  // The contraction: thread (slice, g) sums terms [k0, k1) for channels
  // 4g .. 4g + 3 of every board.  Integer products in double are exact.
  const int groups = O / 4, slices = nt / groups;
  const int g = tid % groups, slice = tid / groups;
  const int per = (K + slices - 1) / slices;
  const int k0 = slice * per, k1 = min(K, k0 + per);
  double acc[BOARDS][4] = {};
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const uint32_t word = __ldg(p.w + static_cast<long long>(k) * groups + g);
    double wd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wd[c] = static_cast<double>(static_cast<int8_t>(word >> (8 * c)));
#pragma unroll
    for (int b = 0; b < BOARDS; ++b) {
      const double t = taps[b * K + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[b][c] = fma(t, wd[c], acc[b][c]);
    }
  }
  __syncthreads();  // every thread is done with the tap sums
  double* part = smem;  // [slices][BOARDS][O]
#pragma unroll
  for (int b = 0; b < BOARDS; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[(slice * BOARDS + b) * O + 4 * g + c] = acc[b][c];
  __syncthreads();

  // mean[o] = bf16(f32(s) * m * (1 / hw) + bias), s the exact sum.
  for (int i = tid; i < BOARDS * O; i += nt) {
    const int o = i % O;
    double s = 0.0;
    for (int sl = 0; sl < slices; ++sl) s += part[sl * BOARDS * O + i];
    const float x = __fmul_rn(__fmul_rn(__double2float_rn(s), p.m[o]), p.inv_hw);
    mean[i] = bf(__fadd_rn(x, p.bias[o]));
  }
  __syncthreads();

  // h = relu(bf16(bf16(mean @ W1) + b1)).
  for (int i = tid; i < BOARDS * hidden; i += nt) {
    const int b = i / hidden, j = i - b * hidden;
    const float* x = mean + b * O;
    float s = 0.f;
    for (int o = 0; o < O; ++o) s = __fadd_rn(s, __fmul_rn(x[o], bf_at(w1, o * hidden + j)));
    const float h = bf(__fadd_rn(bf(s), bf_at(p.b1, j)));
    hid[i] = h > 0.f ? h : 0.f;
  }
  __syncthreads();

  // gate = bf16(sigmoid(bf16(bf16(h @ W2) + b2))).
  for (int i = tid; i < nb * O; i += nt) {
    const int b = i / O, o = i - b * O;
    const float* x = hid + b * hidden;
    float s = 0.f;
    for (int j = 0; j < hidden; ++j) s = __fadd_rn(s, __fmul_rn(x[j], bf_at(w2, j * O + o)));
    const float z = bf(__fadd_rn(bf(s), bf_at(p.b2, o)));
    p.gate[b0 * O + i] = __float2bfloat16_rn(1.0f / (1.0f + expf(-z)));
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// One block's constants, as ops/se_gate.py GateWeights lays them out: the
// addresses of conv2's s8 weight [9C, O], its f32 m and bias [O], and the
// MLP's bf16 w1 [O, hidden], b1 [hidden], w2 [hidden, O] and b2 [O], all
// contiguous on the current device, then the widths.
struct Weights {
  const void *w, *m, *bias, *w1, *b1, *w2, *b2;
  long long C, O, hidden;
};

// The gate [B, O] bf16 of B boards from their tap sums [B, 9C] i32 over
// boards of hw cells: C from 1 to MAX_WIDTH, O a multiple of 4 from 4 to
// MAX_WIDTH, hidden from 1 to MAX_HIDDEN.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int az_se_gate(const void* taps, const Weights* wt, void* gate, long long B,
               long long hw, void* stream) {
  if (wt == nullptr) return cudaErrorInvalidValue;
  const long long C = wt->C, O = wt->O, hidden = wt->hidden;
  if (C < 1 || C > MAX_WIDTH || O % 4 != 0 || O < 4 || O > MAX_WIDTH ||
      hidden < 1 || hidden > MAX_HIDDEN || hw < 1 || B < 0 || B >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (!(aligned(taps, 4) && aligned(wt->w, 4) && aligned(wt->m, 4) &&
        aligned(wt->bias, 4) && aligned(wt->w1, 4) && aligned(wt->b1, 2) &&
        aligned(wt->w2, 4) && aligned(wt->b2, 2) && aligned(gate, 2)) ||
      !taps || !wt->w || !wt->m || !wt->bias || !wt->w1 || !wt->b1 || !wt->w2 ||
      !wt->b2 || !gate)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p{};
  p.taps = static_cast<const int*>(taps);
  p.w = static_cast<const uint32_t*>(wt->w);
  p.m = static_cast<const float*>(wt->m);
  p.bias = static_cast<const float*>(wt->bias);
  p.w1 = static_cast<const uint32_t*>(wt->w1);
  p.b1 = static_cast<const __nv_bfloat16*>(wt->b1);
  p.w2 = static_cast<const uint32_t*>(wt->w2);
  p.b2 = static_cast<const __nv_bfloat16*>(wt->b2);
  p.gate = static_cast<__nv_bfloat16*>(gate);
  p.inv_hw = 1.0f / static_cast<float>(hw);
  p.B = static_cast<int>(B);
  p.K = static_cast<int>(9 * C);
  p.O = static_cast<int>(O);
  p.hidden = static_cast<int>(hidden);
  const size_t smem = smem_bytes(p.K, p.O, p.hidden);
  if (smem > STATIC_SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        se_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned groups = static_cast<unsigned>(O / 4);
  const unsigned threads = (THREADS / groups) * groups;
  const unsigned blocks = static_cast<unsigned>((B + BOARDS - 1) / BOARDS);
  se_gate_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* az_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
