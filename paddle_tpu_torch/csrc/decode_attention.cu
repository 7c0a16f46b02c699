// Decode attention for Hopper (sm_90a): one-token queries against a dense
// or a paged KV cache, with a plain C interface loaded through ctypes
// (paddle_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Replaces the two Pallas TPU kernel bodies of
// paddle_tpu/ops/pallas/decode_attention.py:
//   - _decode_kernel (launcher flash_decode_raw)            -> pt_flash_decode
//       decode_split_kernel + decode_combine_kernel (dense cache, B4)
//   - _paged_decode_kernel, nsp=2 (paged_decode_raw) and nsp=3
//     (ragged_paged_decode_raw)                              -> pt_paged_decode
//       paged_split_kernel + decode_combine_kernel (paged caches, B3 and B3')
//
// What bounds them on the H100: bandwidth.  Each (row, kv head) reads its
// visible K/V rows once and does 4*rep*d flops per visible token, about 4
// flops a byte for bf16 K/V, far below the ~295 flops/byte needed to reach
// the tensor-core limit, so the least time is the visible K/V bytes over
// 3.35 TB/s.  What limits a kernel is how many SMs work and how many bytes
// each keeps in flight.
//
// All three launchers split the visible length over CTAs, the
// flash-decoding scheme:
//   - decode_split_kernel (dense) and paged_split_kernel (paged): one CTA
//     per (chunk of C tokens, kv head, row), the grid sized on the host
//     from static shapes (the lengths stay on the device); a CTA whose
//     chunk starts at or past the row's length exits at once.  One thread
//     issues 1-D bulk copies of the chunk's K rows (one mbarrier per warp's
//     32 keys) and V rows (one more), so the whole chunk is in flight and a
//     warp starts its scores when its own keys land.  Dense: a chunk's rows
//     are contiguous (chunk_row), one window each for K and V.  Paged: C is
//     a whole number of pages and one page of one kv head is contiguous in
//     the pool [n_pages, kvh, page, d] (4 KB at page 16, d 128, bf16), so a
//     chunk is copied page by page (page_row maps a token to its page
//     through the block table), K cut at the warps' 32-key boundaries.
//     Scores on CUDA cores, with no shuffle reduction per score: each
//     thread owns one key and walks d against q staged in shared memory in
//     its own dtype (16-byte pieces, staggered across threads against bank
//     conflicts); a warp per q head takes the chunk's max and sum; for p V
//     each thread owns 8 output columns of one head and walks keys.  The
//     chunk's fp32 partials (m, l, acc[rep, d]) go to a scratch the wrapper
//     allocates (split_chunk, shared by both kernels);
//   - decode_combine_kernel: per (row, q head), merges the row's
//     ceil(len / C) partials in split order (deterministic): M = max m_c,
//     l = sum l_c e^(m_c - M), o = sum acc_c e^(m_c - M) / l, one thread
//     per output column.
//
// Left for later work: the products run on CUDA cores (no mma) and a CTA
// holds one chunk (no pipeline within a CTA); in the ragged mode each row
// of a prefill chunk reads its sequence's pages itself (its own CTAs; L2
// catches the re-reads), where rows of one slot could share staged K/V.
//
// Semantics kept from the TPU kernels (tests/test_flash_decoding.py):
//   - masking with NEG_INF = -1e30, never -inf;
//   - a row that sees no key outputs exactly 0 (valid = m > NEG_INF/2,
//     l == 0 -> 1);
//   - K/V rows past the visible length never enter the sums, so garbage
//     or NaN there (the trash page, unwritten cache) cannot poison them:
//     the copy of a row's last chunk (dense) or page (paged) may bring some
//     in, so their scores are masked and their V rows zeroed (0 x NaN is
//     NaN);
//   - dense lengths clamp to [0, t_max];
//   - paged: the walk covers ceil(max_pages / pp) * pp logical pages, as
//     the TPU grid does, so lengths clamp to that many pages' tokens; the
//     logical page index clamps to max_pages - 1 (lengths past the table
//     re-read its last page) and, for a visible token, never passes the
//     row's last visible page; table entries of -1 clamp to page 0;
//   - ragged rows with slot < 0 are padding: length 0, output 0;
//   - GQA is group-major: q head kv*rep + r reads kv head kv;
//   - scale multiplies the fp32 dot; p is rounded to v's dtype (after the
//     int8 widening, q's dtype) before the PV product, whose sum is fp32,
//     and l sums the unrounded p.  The split kernels round p against their
//     chunk's own max (rescaled in fp32 by the combine), the plain version
//     against the row's max: both stay inside the two-bf16-ulp per-row
//     gate;
//   - int8 K/V are widened to q's dtype in the kernel; the dequant scales
//     stay with the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, 1-D bulk copies

namespace {

constexpr float kNegInf = -1e30f;

enum DTypeCode { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// p is rounded to the PV operand type: v's dtype, or q's dtype for int8 v
template <typename TQ, typename TKV> struct PvType { using type = TKV; };
template <typename TQ> struct PvType<TQ, int8_t> { using type = TQ; };

__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ------------------------- B4 (dense), B3 and B3' (paged): split and combine

constexpr int kSplitThreads = 128;
constexpr int kMaxChunk = kSplitThreads;  // keys of a chunk: one per thread in the score pass
constexpr int kSplitHeads = 8;            // q heads a thread's score pass keeps in registers

struct SplitArgs {
  const void* q;       // [rows, h, d]
  const void* k;       // dense [rows, kvh, t_max, d]; paged pool [n_pages, kvh, page, d]
  const void* v;
  void* o;             // [rows, h, d], q's dtype
  const int* lens;     // [rows] visible length
  const int* slots;    // paged, ragged: [rows] page-table row (< 0 padding); else nullptr
  const int* tables;   // paged: [slots, max_pages] physical page ids; else nullptr
  float* part_m;       // [rows, h, splits] chunk max (the scores' units)
  float* part_l;       // [rows, h, splits] chunk sum of the unrounded p
  float* part_acc;     // [rows, h, splits, d] chunk sum of p V
  int h, kvh, rep;
  int t_max;           // dense: cache rows; paged: tokens of the walked pages
  int page, max_pages;  // paged: tokens per page, table width
  int chunk, splits;   // C tokens per chunk, ceil(t_max / C) chunks
  float scale;
};

// A row's visible length: clamped to [0, t_max]; a ragged padding row
// (slot < 0) sees nothing
__device__ __forceinline__ int row_len(const SplitArgs& a, int row) {
  if (a.slots != nullptr && a.slots[row] < 0) return 0;
  return min(max(a.lens[row], 0), a.t_max);
}

// The cache row index of the first token of chunk c0 of (row, kv head g):
// in the dense layout a chunk's K rows (and V rows) are contiguous from
// here.
__device__ __forceinline__ size_t chunk_row(const SplitArgs& a, int row, int g, int c0) {
  return (static_cast<size_t>(row) * a.kvh + g) * a.t_max + c0;
}

// The pool row index of token t of (table row `table`, kv head g): its
// logical page clamped to the table's width, the physical page id clamped
// to 0 (-1 marks an unused entry); the rest of t's page follows it.
__device__ __forceinline__ size_t page_row(const SplitArgs& a, const int* table, int g, int t) {
  const int li = min(t / a.page, a.max_pages - 1);
  const size_t phys = static_cast<size_t>(max(table[li], 0));
  return (phys * a.kvh + g) * a.page + t % a.page;
}

// A K/V row as 16-byte pieces (the whole row when it is shorter: int8 at d
// 8), each widened to fp32.
template <typename T, int D>
struct Row {
  static constexpr int kBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kPieceBytes = kBytes < 16 ? kBytes : 16;
  static constexpr int kPiece = kPieceBytes / static_cast<int>(sizeof(T));  // elements
  static constexpr int kPieces = kBytes / kPieceBytes;
};

// n 32-bit words of T as fp32 (x holds 4 / sizeof(T) values per word)
__device__ __forceinline__ void widen_words(const uint32_t* w, int n, float* x, float*) {
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = __uint_as_float(w[i]);
}
__device__ __forceinline__ void widen_words(const uint32_t* w, int n, float* x, __nv_bfloat16*) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen_words(const uint32_t* w, int n, float* x, int8_t*) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * b)) & 0xffu));
}

// N elements of type T at p in shared memory (8 bytes aligned to 8, or a
// multiple of 16 bytes aligned to 16) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_widen(const unsigned char* p, float (&x)[N]) {
  constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  static_assert(kWords == 2 || kWords % 4 == 0, "an 8-byte or 16-byte multiple");
  uint32_t w[kWords];
  if constexpr (kWords == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < kWords; i += 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + 4 * i);
      w[i] = u.x;
      w[i + 1] = u.y;
      w[i + 2] = u.z;
      w[i + 3] = u.w;
    }
  }
  widen_words(w, kWords, x, static_cast<T*>(nullptr));
}

// Dynamic shared memory of decode_split_kernel: the K and V chunks (each C
// rows plus 32 bytes of slack for the 16-byte-aligned copy windows), q in
// its own dtype [rep][D], the scores then p [rep][C], the PV partial sums
// [slices][rep][D] and the chunk's m, l [rep].  Offsets are 128-byte
// aligned.
struct SplitSmem {
  size_t kv, q, s, red, ml, bytes;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// PV work: units of (q head, 8 columns); when there are fewer units than
// threads, `slices` threads share a unit, each over every slices-th key
__host__ __device__ inline int pv_slices(int rep, int d) {
  const int units = rep * d / 8;
  return units >= kSplitThreads ? 1 : kSplitThreads / units;
}

__host__ __device__ inline SplitSmem split_smem(int rep, int d, int chunk, int q_bytes,
                                                int kv_bytes) {
  SplitSmem m;
  m.kv = align128(static_cast<size_t>(chunk) * d * kv_bytes + 32);
  m.q = 2 * m.kv;
  m.s = m.q + align128(static_cast<size_t>(q_bytes) * rep * d);
  m.red = m.s + align128(sizeof(float) * rep * chunk);
  m.ml = m.red + align128(sizeof(float) * pv_slices(rep, d) * rep * d);
  m.bytes = m.ml + sizeof(float) * 2 * rep;
  return m;
}

// K arrives in up to kSplitWarps copies, one per warp's 32 keys, so that a
// warp starts its scores when its own keys land
constexpr int kSplitWarps = kSplitThreads / 32;

// The work of one chunk of (row, kv head g), shared by the dense and the
// paged split kernel once thread 0 has initialised the barriers and issued
// the chunk's copies: K row j at k_s + j * row bytes (warp w's keys on
// bars[w], and also on bars[w + 1] when SPILL: the dense windows' bounds
// are rounded down to 16 bytes, so a warp's last key may lie in the next
// window), V row j at v_s + j * row bytes on bars[kSplitWarps].  n visible
// keys, k_copies barriers of K copies.  Writes the chunk's partials at
// split index c.
template <typename TQ, typename TKV, int D, bool SPILL>
__device__ __forceinline__ void split_chunk(const SplitArgs& a, unsigned char* dyn,
                                            uint64_t* bars, const unsigned char* k_s,
                                            unsigned char* v_s, int row, int g, int c, int n,
                                            int k_copies) {
  using TP = typename PvType<TQ, TKV>::type;
  using R = Row<TKV, D>;
  const int n4 = min((n + 3) & ~3, a.chunk);  // the PV pass walks keys in fours
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.rep;
  const SplitSmem L = split_smem(rep, D, a.chunk, sizeof(TQ), sizeof(TKV));
  TQ* q_s = reinterpret_cast<TQ*>(dyn + L.q);
  float* s_s = reinterpret_cast<float*>(dyn + L.s);
  float* red_s = reinterpret_cast<float*>(dyn + L.red);
  float* m_s = reinterpret_cast<float*>(dyn + L.ml);
  float* l_s = m_s + rep;

  const TQ* q = static_cast<const TQ*>(a.q) + (static_cast<size_t>(row) * a.h + static_cast<size_t>(g) * rep) * D;
  for (int i = tid; i < rep * D; i += kSplitThreads) q_s[i] = q[i];
  __syncthreads();  // q staged, the barriers initialised

  // scores: thread j owns key j and walks d (pieces staggered by j) against
  // q from shared memory; keys past the length score NEG_INF.  A warp waits
  // for the copies that hold its rows.
  if (tid < a.chunk) {
    const int j = tid;
    if (j < n) {
      mbar_wait(&bars[warp], 0);
      if (SPILL && warp + 1 < k_copies) mbar_wait(&bars[warp + 1], 0);
    }
    for (int r0 = 0; r0 < rep; r0 += kSplitHeads) {
      float acc[kSplitHeads];
#pragma unroll
      for (int rr = 0; rr < kSplitHeads; ++rr) acc[rr] = 0.f;
      if (j < n) {
        // fp32 q over int8 K/V holds 16 widened pieces of each: unrolled by
        // 4, ptxas spills in the paged kernel at d 128
#pragma unroll(sizeof(TQ) == 4 && sizeof(TKV) == 1 ? 2 : 4)
        for (int i = 0; i < R::kPieces; ++i) {
          const int pc = (i + j) & (R::kPieces - 1);
          float kx[R::kPiece];
          load_widen<TKV>(k_s + j * R::kBytes + pc * R::kPieceBytes, kx);
#pragma unroll
          for (int rr = 0; rr < kSplitHeads; ++rr) {
            if (r0 + rr < rep) {
              float qx[R::kPiece];
              load_widen<TQ>(reinterpret_cast<const unsigned char*>(
                                 q_s + (r0 + rr) * D + pc * R::kPiece),
                             qx);
#pragma unroll
              for (int e = 0; e < R::kPiece; ++e) acc[rr] += qx[e] * kx[e];
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kSplitHeads; ++rr)
        if (r0 + rr < rep) s_s[(r0 + rr) * a.chunk + j] = j < n ? acc[rr] * a.scale : kNegInf;
    }
  }
  __syncthreads();

  // the chunk's softmax: one warp per q head over keys [0, n4)
  for (int r = warp; r < rep; r += kSplitWarps) {
    float mx = kNegInf;
    for (int j = lane; j < n4; j += 32) mx = fmaxf(mx, s_s[r * a.chunk + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n4; j += 32) {
      const float p = expf(s_s[r * a.chunk + j] - mx);
      sum += p;
      s_s[r * a.chunk + j] = round_to(p, static_cast<TP*>(nullptr));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  // warps whose keys are all past the length never waited for their K
  // copies: every copy lands before the CTA may exit
  for (int w = 0; w < k_copies; ++w) mbar_wait(&bars[w], 0);
  mbar_wait(&bars[kSplitWarps], 0);
  // V rows [n, n4) past the length: zero, so p = 0 meets 0 and not NaN
  for (int i = tid; i < (n4 - n) * R::kBytes / 4; i += kSplitThreads)
    reinterpret_cast<uint32_t*>(v_s + n * R::kBytes)[i] = 0u;
  __syncthreads();

  // p V: a unit is (q head r, 8 columns); `slices` threads per unit split
  // the keys, their fp32 sums added in shared memory
  constexpr int kGroups = D / 8;
  const int units = rep * kGroups;
  const int slices = pv_slices(rep, D);
  for (int it = tid; it < units * slices; it += kSplitThreads) {
    const int u = it % units, sl = it / units;
    const int r = u / kGroups, cg = u % kGroups;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    const float* p_r = s_s + r * a.chunk;
#pragma unroll 4
    for (int j = sl; j < n4; j += slices) {
      const float p = p_r[j];
      float vx[8];
      load_widen<TKV>(v_s + j * R::kBytes + cg * 8 * sizeof(TKV), vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += p * vx[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red_s[(sl * rep + r) * D + cg * 8 + e] = acc[e];
  }
  __syncthreads();

  const size_t head0 = static_cast<size_t>(row) * a.h + static_cast<size_t>(g) * rep;
  for (int idx = tid; idx < rep * D; idx += kSplitThreads) {
    float sum = 0.f;
    for (int sl = 0; sl < slices; ++sl) sum += red_s[sl * rep * D + idx];
    const size_t at = (head0 + idx / D) * a.splits + c;
    a.part_acc[at * D + idx % D] = sum;
  }
  for (int r = tid; r < rep; r += kSplitThreads) {
    const size_t at = (head0 + r) * a.splits + c;
    a.part_m[at] = m_s[r];
    a.part_l[at] = l_s[r];
  }
}

// B4: the dense cache.  The chunk's rows [c0, c0 + n4), cut at t_max, in
// 16-byte-aligned copy windows (K and V are 16-byte aligned, so both share
// one shift): K in one window per warp's 32 rows, boundaries rounded down
// to 16 bytes (a warp's last row may end in the next window), V in one.
// Rows past the length that the windows bring in are masked (K) and zeroed
// (V) by split_chunk.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(SplitArgs a) {
  using R = Row<TKV, D>;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(8) uint64_t bars[kSplitWarps + 1];  // K by warp, then V

  const int c = blockIdx.x, g = blockIdx.y, row = blockIdx.z;
  const int len = row_len(a, row);
  const int c0 = c * a.chunk;
  if (c0 >= len) return;  // no visible token in this chunk: no copy, no partial
  const int n = min(a.chunk, len - c0);  // visible tokens of the chunk
  const int n4 = min((n + 3) & ~3, a.chunk);
  const SplitSmem L = split_smem(a.rep, D, a.chunk, sizeof(TQ), sizeof(TKV));

  const size_t first = chunk_row(a, row, g, c0) * R::kBytes;
  const int rows_in = min(n4, a.t_max - c0);
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + first;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + first;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(kg) & 15);
  const int end = (shift + rows_in * R::kBytes + 15) & ~15;  // bytes of the window
  const int k_copies = (rows_in + 31) / 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kSplitWarps; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int w = 0; w < k_copies; ++w) {
      const int lo = (shift + w * 32 * R::kBytes) & ~15;
      const int hi = w + 1 < k_copies ? (shift + (w + 1) * 32 * R::kBytes) & ~15 : end;
      mbar_arrive_expect_tx(&bars[w], hi - lo);
      bulk_load_1d(dyn + lo, kg - shift + lo, hi - lo, &bars[w]);
    }
    mbar_arrive_expect_tx(&bars[kSplitWarps], end);
    bulk_load_1d(dyn + L.kv, vg - shift, end, &bars[kSplitWarps]);
  }
  split_chunk<TQ, TKV, D, true>(a, dyn, bars, dyn + shift, dyn + L.kv + shift, row, g, c, n,
                                k_copies);
}

// B3 and B3': the paged pools.  The chunk is C / page whole pages of the
// row's table row; its pages with a visible token are copied whole (rows
// past the length masked and zeroed by split_chunk), K in pieces cut at the
// warps' 32-key boundaries, each piece on its warp's barrier, V page by
// page on one barrier.  A page of one kv head is contiguous in the pool.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kSplitThreads) paged_split_kernel(SplitArgs a) {
  using R = Row<TKV, D>;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(8) uint64_t bars[kSplitWarps + 1];  // K by warp, then V

  const int c = blockIdx.x, g = blockIdx.y, row = blockIdx.z;
  const int len = row_len(a, row);
  const int c0 = c * a.chunk;
  if (c0 >= len) return;  // no visible token in this chunk: no copy, no partial
  int n = min(a.chunk, len - c0);  // visible tokens of the paged chunk
  const SplitSmem L = split_smem(a.rep, D, a.chunk, sizeof(TQ), sizeof(TKV));
  const int* table = a.tables + static_cast<size_t>(a.slots != nullptr ? a.slots[row] : row) *
                                    a.max_pages;
  const int rows_in = (n + a.page - 1) / a.page * a.page;  // the copied pages' rows
  const int k_copies = (rows_in + 31) / 32;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kSplitWarps; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int w = 0; w < k_copies; ++w) {
      const int lo = w * 32, hi = min(lo + 32, rows_in);
      mbar_arrive_expect_tx(&bars[w], (hi - lo) * R::kBytes);
      for (int j = lo; j < hi;) {
        const int next = min((j / a.page + 1) * a.page, hi);  // the end of j's page
        bulk_load_1d(dyn + j * R::kBytes, kg + page_row(a, table, g, c0 + j) * R::kBytes,
                     (next - j) * R::kBytes, &bars[w]);
        j = next;
      }
    }
    mbar_arrive_expect_tx(&bars[kSplitWarps], rows_in * R::kBytes);
    for (int j = 0; j < rows_in; j += a.page)
      bulk_load_1d(dyn + L.kv + j * R::kBytes, vg + page_row(a, table, g, c0 + j) * R::kBytes,
                   a.page * R::kBytes, &bars[kSplitWarps]);
  }
  split_chunk<TQ, TKV, D, false>(a, dyn, bars, dyn, dyn + L.kv, row, g, c, n, k_copies);
}

// One CTA per (q head, row): the row's ns = ceil(len / C) partial m and l
// staged in shared memory, M = max m_c by a block reduction (exact in any
// order), then thread dd merges column dd in split order: l = sum l_c
// e^(m_c - M), o = sum acc_c e^(m_c - M) / l.
template <typename TQ, int D>
__global__ void __launch_bounds__(kSplitThreads) decode_combine_kernel(SplitArgs a) {
  extern __shared__ float comb[];  // [splits] m, then [splits] l
  __shared__ float wmax[kSplitWarps];
  const int head = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ns = (row_len(a, row) + a.chunk - 1) / a.chunk;  // chunks that hold a visible token
  const size_t base = (static_cast<size_t>(row) * a.h + head) * a.splits;
  float* m_c = comb;
  float* l_c = comb + a.splits;
  float mx = kNegInf;
  for (int c = tid; c < ns; c += kSplitThreads) {
    m_c[c] = a.part_m[base + c];
    l_c[c] = a.part_l[base + c];
    mx = fmaxf(mx, m_c[c]);
  }
  mx = warp_max(mx);
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  mx = wmax[0];
#pragma unroll
  for (int w = 1; w < kSplitWarps; ++w) mx = fmaxf(mx, wmax[w]);
  if (tid >= D) return;
  const float* acc_c = a.part_acc + base * D + tid;
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < ns; ++c) {  // merge in split order
    const float w = expf(m_c[c] - mx);
    l += l_c[c] * w;
    acc += acc_c[static_cast<size_t>(c) * D] * w;
  }
  if (l == 0.f) l = 1.f;
  const bool valid = mx > kNegInf * 0.5f;
  store(static_cast<TQ*>(a.o) + (static_cast<size_t>(row) * a.h + head) * D + tid,
        valid ? acc / l : 0.f);
}

template <typename TQ, typename TKV, int D, bool PAGED>
cudaError_t launch_split(const SplitArgs& a, int rows, cudaStream_t stream) {
  const size_t smem = split_smem(a.rep, D, a.chunk, sizeof(TQ), sizeof(TKV)).bytes;
  const size_t comb = sizeof(float) * 2 * static_cast<size_t>(a.splits);
  if (a.chunk <= 0 || a.chunk > kMaxChunk || smem > 232448 || comb > 232448)
    return cudaErrorInvalidValue;
  // paged: whole pages per chunk, each page's K/V bytes a multiple of 16 (1-D bulk copies)
  if (PAGED && (a.page <= 0 || a.chunk % a.page != 0 || a.max_pages <= 0 ||
                (a.page * D * static_cast<int>(sizeof(TKV))) % 16 != 0))
    return cudaErrorInvalidValue;
  auto split = PAGED ? paged_split_kernel<TQ, TKV, D> : decode_split_kernel<TQ, TKV, D>;
  auto combine = decode_combine_kernel<TQ, D>;
  cudaError_t e = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(combine, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(comb));
  if (e != cudaSuccess) return e;
  split<<<dim3(a.splits, a.kvh, rows), kSplitThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine<<<dim3(a.h, rows), kSplitThreads, comb, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t launch_d(const SplitArgs& a, int rows, int d, cudaStream_t s) {
  switch (d) {
    case 8: return launch_split<TQ, TKV, 8, PAGED>(a, rows, s);
    case 16: return launch_split<TQ, TKV, 16, PAGED>(a, rows, s);
    case 32: return launch_split<TQ, TKV, 32, PAGED>(a, rows, s);
    case 64: return launch_split<TQ, TKV, 64, PAGED>(a, rows, s);
    case 128: return launch_split<TQ, TKV, 128, PAGED>(a, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// the (q dtype, K/V dtype) pairs the launchers take
template <bool PAGED>
int dispatch(const SplitArgs& a, int rows, int d, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32) return launch_d<float, float, PAGED>(a, rows, d, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16, PAGED>(a, rows, d, s);
  if (q_dtype == kF32 && kv_dtype == kI8) return launch_d<float, int8_t, PAGED>(a, rows, d, s);
  // an fp32 model over a bf16 cache (an int8-weight dict serves on bf16 pools)
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return launch_d<float, __nv_bfloat16, PAGED>(a, rows, d, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_d<__nv_bfloat16, int8_t, PAGED>(a, rows, d, s);
  return cudaErrorInvalidValue;
}

SplitArgs split_args(const void* q, const void* k, const void* v, void* o, const void* lens,
                     void* part_m, void* part_l, void* part_acc, int h, int kvh, int t_max,
                     int chunk, float scale) {
  SplitArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lens = static_cast<const int*>(lens);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.h = h;
  a.kvh = kvh;
  a.rep = h / kvh;
  a.t_max = t_max;
  a.chunk = chunk;
  a.splits = chunk > 0 ? (t_max + chunk - 1) / chunk : 0;
  a.scale = scale;
  return a;
}

// the paged launchers' walk: ceil(max_pages / pp) * pp logical pages
SplitArgs paged_split_args(const void* q, const void* k, const void* v, void* o,
                           const void* lens, const void* tables, void* part_m, void* part_l,
                           void* part_acc, int h, int kvh, int page, int max_pages, int pp,
                           int chunk, float scale) {
  const int walked = pp > 0 ? (max_pages + pp - 1) / pp * pp : 0;
  SplitArgs a = split_args(q, k, v, o, lens, part_m, part_l, part_acc, h, kvh, walked * page,
                           chunk, scale);
  a.tables = static_cast<const int*>(tables);
  a.page = page;
  a.max_pages = max_pages;
  return a;
}

}  // namespace

extern "C" {

// flash_decode_raw: q [b, h, d]; k/v [b, kvh, t_max, d]; seq_lens [b] int32.
// Two launches: decode_split_kernel over chunks of `chunk` tokens (partials
// into part_m, part_l [b, h, ceil(t_max / chunk)] and part_acc [.., d], fp32
// scratch of the caller), then decode_combine_kernel into o.
int pt_flash_decode(const void* q, const void* k, const void* v, void* o, const void* seq_lens,
                    void* part_m, void* part_l, void* part_acc, int b, int h, int kvh,
                    int t_max, int d, int chunk, float scale, int q_dtype, int kv_dtype,
                    void* stream) {
  const SplitArgs a = split_args(q, k, v, o, seq_lens, part_m, part_l, part_acc, h, kvh, t_max,
                                 chunk, scale);
  return dispatch<false>(a, b, d, q_dtype, kv_dtype, stream);
}

// paged_decode_raw and ragged_paged_decode_raw: q [rows, h, d]; pools
// [n_pages, kvh, page, d]; lens [rows]; row_slot [rows] (< 0 = padding), or
// nullptr for one row per table row; block_tables [slots, max_pages] (-1 =
// unused).  paged_split_kernel over chunks of `chunk` tokens (whole pages)
// of the walked length ceil(max_pages / pp) * pp * page, partials as
// pt_flash_decode's, then decode_combine_kernel.
int pt_paged_decode(const void* q, const void* k, const void* v, void* o, const void* lens,
                    const void* row_slot, const void* block_tables, void* part_m, void* part_l,
                    void* part_acc, int rows, int h, int kvh, int page, int d, int max_pages,
                    int pp, int chunk, float scale, int q_dtype, int kv_dtype, void* stream) {
  SplitArgs a = paged_split_args(q, k, v, o, lens, block_tables, part_m, part_l, part_acc, h,
                                 kvh, page, max_pages, pp, chunk, scale);
  a.slots = static_cast<const int*>(row_slot);
  return dispatch<true>(a, rows, d, q_dtype, kv_dtype, stream);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
