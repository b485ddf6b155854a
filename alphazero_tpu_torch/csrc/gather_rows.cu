// gather_rows: per-lane arena row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel alphazero_tpu/ops/gather_rows.py::gather_rows
// (which gathers one row per lane with scalar-prefetched indices and one
// HBM->VMEM DMA per row), generalised to M rows per lane and to several
// arenas read at one index in one launch:
//
//   out_a[b, m, :] = arr_a[b, idx[b, m], :]   for 0 <= idx[b, m] < N_a
//   out_a[b, m, :] = 0                        otherwise (e.g. the search's -1)
//
// It is a byte copy of rows, so it serves every dtype: the host passes each
// arena's row length in bytes.  Indices are read as they lie, int32 or int64
// (the kernel is templated on the index type), so no cast precedes it.
//
// What bounds it on the card: bytes moved (each gathered row read once, each
// output row written once, plus the indices) and, at the search's small
// shapes (B = 1024 lanes x 16..512 rows of 1..225 bytes, a few MB at most per
// call), the launch.  So the design aims at full-width memory words and at
// one launch for every arena the search reads at one index.
//
// The output of an arena is contiguous, [B * M, L] bytes, so the kernel
// walks OUTPUT words, not rows: one thread writes one aligned word, and
// neighbouring threads write neighbouring words whatever the row length.
// A thread works out which output row and which byte of it its word starts
// at (a multiply-high by a reciprocal the host computes, not a division),
// reads the source row's bytes there and stores the word.
//   * Where the row length and the arena's base allow it, words are 16, 8 or
//     4 bytes and every word lies inside one row at an aligned source
//     offset: a plain vector copy.
//   * Any other row length of 16 bytes or more (the 225-byte Gomoku board)
//     takes 16-byte output chunks with shifts: inside one source row the
//     chunk's bytes sit in five aligned source words at most, and
//     __funnelshift_r puts them in place; a chunk that straddles two output
//     rows (one in 14 at 225 bytes) builds each of its four words from the
//     end of one source row and the start of the next, both indices loaded
//     before either row.  Rows of 4 to 15 bytes take 4-byte words the same
//     way.  Nothing is read outside a source row but the rest of an aligned
//     word that holds one of its bytes.
//   * Rows of 1 to 3 bytes (a word covers up to four rows) take their words
//     byte by byte; the last word of an output that ends inside a word is
//     stored byte by byte.
//
// Several arenas, one launch: the host passes a table of up to MAX_ARENAS
// descriptors by value (source, output, N, row bytes, word width, first
// thread).  The grid is split across the arenas by a prefix of their word
// counts, each rounded up to a warp so that no warp spans two arenas.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ARENAS = 8;
constexpr int THREADS = 256;

struct Arena {
  const unsigned char* src;  // [B, N, L] bytes
  unsigned char* out;        // [B * M, L] bytes, contiguous
  long long N;
  unsigned L, L_magic;  // bytes a row, and magic(L)
  unsigned width;  // 16, 8, 4: aligned words; 2: 16-byte chunks with
                   // shifts (L >= 16); 1: 4-byte words with shifts (L >= 4);
                   // 0: 4-byte words byte by byte (L < 4)
  unsigned words;  // threads this arena needs
  unsigned first;  // its first thread, a multiple of 32
};

struct Table {
  Arena a[MAX_ARENAS];
  int count;
};

// n / d for n, d < 2^31, with m = magic(d): the multiply-high is floor(n / d)
// or one more (one less for d == 1), and one comparison each way corrects it.
__device__ __forceinline__ unsigned fast_div(unsigned n, unsigned d, unsigned m) {
  unsigned q = __umulhi(n, m);
  if (q * d > n)
    --q;
  else if ((q + 1) * d <= n)
    ++q;
  return q;
}

unsigned magic(unsigned d) {
  return d == 1 ? 0xffffffffu
                : static_cast<unsigned>(((1ull << 32) + d - 1) / d);
}

// The source row of output row r for index i, or null where i is out of
// range.
__device__ __forceinline__ const unsigned char* source_row(const Arena& e,
                                                           long long i,
                                                           unsigned r,
                                                           unsigned M,
                                                           unsigned M_magic) {
  if (i < 0 || i >= e.N) return nullptr;
  const long long b = fast_div(r, M, M_magic);
  return e.src + (b * e.N + i) * e.L;
}

template <typename V, typename I>
__device__ __forceinline__ void copy_word(const Arena& e,
                                          const I* __restrict__ idx,
                                          unsigned w, unsigned M,
                                          unsigned M_magic) {
  const unsigned ob = w * static_cast<unsigned>(sizeof(V));
  const unsigned r = fast_div(ob, e.L, e.L_magic), o = ob - r * e.L;
  const unsigned char* row = source_row(e, idx[r], r, M, M_magic);
  V v{};  // value-initialised: all bytes 0
  if (row != nullptr) v = *reinterpret_cast<const V*>(row + o);
  *reinterpret_cast<V*>(e.out + ob) = v;
}

// The n (1..4) bytes at p as the low bytes of a word, the rest zero: one or
// two aligned loads and a funnel shift.
__device__ __forceinline__ uint32_t read_bytes(const unsigned char* p,
                                               unsigned n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t sh = static_cast<uint32_t>(a & 3);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a - sh);
  const uint32_t lo = q[0], hi = sh + n > 4 ? q[1] : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 8 * sh);
  return n >= 4 ? v : v & ((1u << (8 * n)) - 1);
}

// Stores the word, or its bytes up to the end of the output.
__device__ __forceinline__ void store_word(unsigned char* out, unsigned ob,
                                           unsigned total, uint32_t v) {
  if (ob + 4 <= total) {
    *reinterpret_cast<uint32_t*>(out + ob) = v;
  } else {
    for (unsigned j = 0; ob + j < total; ++j) out[ob + j] = (v >> (8 * j)) & 0xff;
  }
}

// One 4-byte output word of rows of 4 bytes or more, any source alignment.
template <typename I>
__device__ __forceinline__ void shift_word(const Arena& e,
                                           const I* __restrict__ idx,
                                           unsigned w, unsigned rows,
                                           unsigned M, unsigned M_magic) {
  const unsigned total = rows * e.L;  // output bytes
  const unsigned ob = 4 * w;
  const unsigned r = fast_div(ob, e.L, e.L_magic), o = ob - r * e.L;
  const unsigned n0 = e.L - o < 4 ? e.L - o : 4;  // bytes from row r
  const bool next = n0 < 4 && r + 1 < rows;        // the rest from row r + 1
  const long long i0 = static_cast<long long>(idx[r]);
  const long long i1 = next ? static_cast<long long>(idx[r + 1]) : -1;
  const unsigned char* row0 = source_row(e, i0, r, M, M_magic);
  const unsigned char* row1 = source_row(e, i1, r + 1, M, M_magic);
  uint32_t v = row0 != nullptr ? read_bytes(row0 + o, n0) : 0u;
  if (row1 != nullptr) v |= read_bytes(row1, 4 - n0) << (8 * n0);
  store_word(e.out, ob, total, v);
}

// 16 output bytes (four words) of rows of 16 bytes or more, any source
// alignment; the output's base is 16-byte aligned.
template <typename I>
__device__ __forceinline__ void shift_chunk(const Arena& e,
                                            const I* __restrict__ idx,
                                            unsigned w, unsigned rows,
                                            unsigned M, unsigned M_magic) {
  const unsigned total = rows * e.L;
  const unsigned ob = 16 * w;
  const unsigned r = fast_div(ob, e.L, e.L_magic), o = ob - r * e.L;
  const bool inside = o + 16 <= e.L;
  const long long i0 = static_cast<long long>(idx[r]);
  const long long i1 =
      !inside && r + 1 < rows ? static_cast<long long>(idx[r + 1]) : -1;
  const unsigned char* row0 = source_row(e, i0, r, M, M_magic);
  const unsigned char* row1 = source_row(e, i1, r + 1, M, M_magic);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (inside) {
    if (row0 != nullptr) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(row0 + o);
      const uint32_t sh = static_cast<uint32_t>(a & 3);
      const uint32_t* q = reinterpret_cast<const uint32_t*>(a - sh);
      uint32_t x[5];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = q[k];
      x[4] = sh ? q[4] : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(x[k], x[k + 1], 8 * sh);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned ok = o + 4 * k;  // the word's offset in row r
      if (ok < e.L) {
        const unsigned n0 = e.L - ok < 4 ? e.L - ok : 4;
        if (row0 != nullptr) v[k] = read_bytes(row0 + ok, n0);
        if (n0 < 4 && row1 != nullptr) v[k] |= read_bytes(row1, 4 - n0) << (8 * n0);
      } else if (row1 != nullptr) {
        v[k] = read_bytes(row1 + (ok - e.L), 4);
      }
    }
  }
  if (ob + 16 <= total) {
    *reinterpret_cast<uint4*>(e.out + ob) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) store_word(e.out, ob + 4 * k, total, v[k]);
  }
}

// One 4-byte output word of rows of 1 to 3 bytes, byte by byte.
template <typename I>
__device__ __forceinline__ void byte_word(const Arena& e,
                                          const I* __restrict__ idx,
                                          unsigned w, unsigned rows,
                                          unsigned M, unsigned M_magic) {
  const unsigned total = rows * e.L;
  const unsigned ob = 4 * w;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned bj = ob + j;
    if (bj < total) {
      const unsigned rj = fast_div(bj, e.L, e.L_magic);
      const unsigned char* row = source_row(e, idx[rj], rj, M, M_magic);
      if (row != nullptr) v |= static_cast<uint32_t>(row[bj - rj * e.L]) << (8 * j);
    }
  }
  store_word(e.out, ob, total, v);
}

template <typename I>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const __grid_constant__ Table t, const I* __restrict__ idx,
                   unsigned rows, unsigned M, unsigned M_magic) {
  const unsigned g = blockIdx.x * THREADS + threadIdx.x;
  int k = 0;
#pragma unroll
  for (int j = 1; j < MAX_ARENAS; ++j)
    if (j < t.count && g >= t.a[j].first) k = j;
  const Arena& e = t.a[k];
  const unsigned w = g - e.first;
  if (w >= e.words) return;
  switch (e.width) {
    case 16: copy_word<uint4>(e, idx, w, M, M_magic); break;
    case 8: copy_word<uint2>(e, idx, w, M, M_magic); break;
    case 4: copy_word<uint32_t>(e, idx, w, M, M_magic); break;
    case 2: shift_chunk(e, idx, w, rows, M, M_magic); break;
    case 1: shift_word(e, idx, w, rows, M, M_magic); break;
    default: byte_word(e, idx, w, rows, M, M_magic); break;
  }
}

// The widest aligned word of 16, 8 or 4 bytes that every row offset and both
// bases allow; else 2 (16-byte chunks with shifts) for rows of 16 bytes or
// more into a 16-byte aligned output, 1 (4-byte words with shifts) for rows
// of 4 bytes or more, 0 (byte by byte) for shorter rows.
unsigned width_for(unsigned L, const void* src, const void* out) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  for (unsigned w = 16; w >= 4; w /= 2)
    if (L % w == 0 && s % w == 0 && o % w == 0) return w;
  if (L >= 16 && o % 16 == 0) return 2;
  return L >= 4 ? 1 : 0;
}


// Fills t.a[k] and returns false where the sizes exceed the kernel's 32-bit
// offsets.  `first` is the thread the arena starts at.
bool describe(Arena& e, const void* src, void* out, long long N, long long L,
              long long rows, unsigned first) {
  const long long total = rows * L;
  if (L <= 0 || total >= (1ll << 31) || N < 0) return false;
  e.src = static_cast<const unsigned char*>(src);
  e.out = static_cast<unsigned char*>(out);
  e.N = N;
  e.L = static_cast<unsigned>(L);
  e.L_magic = magic(e.L);
  e.width = width_for(e.L, src, out);
  const long long bytes = e.width == 2 ? 16 : e.width <= 1 ? 4 : e.width;
  e.words = static_cast<unsigned>((total + bytes - 1) / bytes);
  e.first = first;
  return true;
}

cudaError_t launch(const Table& t, const void* idx, int idx_bytes,
                   unsigned rows, unsigned M, unsigned threads,
                   cudaStream_t stream) {
  const unsigned blocks = (threads + THREADS - 1) / THREADS;
  if (blocks == 0) return cudaSuccess;
  if (idx_bytes == 4)
    gather_rows_kernel<int32_t><<<blocks, THREADS, 0, stream>>>(
        t, static_cast<const int32_t*>(idx), rows, M, magic(M));
  else if (idx_bytes == 8)
    gather_rows_kernel<int64_t><<<blocks, THREADS, 0, stream>>>(
        t, static_cast<const int64_t*>(idx), rows, M, magic(M));
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points: idx [B, M] int32 or int64 (idx_bytes 4 or 8), arenas
// [B, N, L bytes] and outputs [B, M, L bytes], all contiguous on the current
// device.  They launch on `stream` and return cudaGetLastError() (0 on
// success).

int az_gather_rows(const void* arr, const void* idx, int idx_bytes, void* out,
                   long long B, long long N, long long M, long long row_bytes,
                   void* stream) {
  const long long rows = B * M;
  if (rows == 0 || row_bytes == 0) return 0;
  if (rows >= (1ll << 31)) return cudaErrorInvalidValue;
  Table t{};
  t.count = 1;
  if (!describe(t.a[0], arr, out, N, row_bytes, rows, 0))
    return cudaErrorInvalidValue;
  return launch(t, idx, idx_bytes, static_cast<unsigned>(rows),
                static_cast<unsigned>(M), t.a[0].words,
                static_cast<cudaStream_t>(stream));
}

// `arenas`: `count` (<= 8) groups of four: source pointer, output pointer,
// N, row bytes.  One launch for all of them.
int az_gather_rows_many(const long long* arenas, int count, const void* idx,
                        int idx_bytes, long long B, long long M, void* stream) {
  const long long rows = B * M;
  if (count < 1 || count > MAX_ARENAS || rows >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  Table t{};
  long long next = 0;  // first thread of the next arena
  for (int k = 0; k < count; ++k) {
    const long long* d = arenas + 4 * k;
    const long long L = d[3];
    if (L == 0) continue;  // nothing to copy: leave it out of the table
    Arena& e = t.a[t.count];
    if (!describe(e, reinterpret_cast<const void*>(d[0]),
                  reinterpret_cast<void*>(d[1]), d[2], L, rows,
                  static_cast<unsigned>(next)))
      return cudaErrorInvalidValue;
    next += (e.words + 31) / 32 * 32;
    if (next >= (1ll << 31)) return cudaErrorInvalidValue;
    ++t.count;
  }
  if (t.count == 0) return 0;
  return launch(t, idx, idx_bytes, static_cast<unsigned>(rows),
                static_cast<unsigned>(M), static_cast<unsigned>(next),
                static_cast<cudaStream_t>(stream));
}

const char* az_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
