// Decode attention for Hopper (sm_90a): one-token queries against a dense
// or a paged KV cache, with a plain C interface loaded through ctypes
// (paddle_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Replaces the two Pallas TPU kernel bodies of
// paddle_tpu/ops/pallas/decode_attention.py:
//   - _decode_kernel (launcher flash_decode_raw)            -> pt_flash_decode
//   - _paged_decode_kernel, nsp=2 (paged_decode_raw)        -> pt_paged_decode
//   - _paged_decode_kernel, nsp=3 (ragged_paged_decode_raw) -> pt_ragged_paged_decode
// One kernel template serves all three; PAGED selects the addressing.
//
// What bounds it on the H100: bandwidth.  Each (row, kv head) reads its
// visible K/V rows once and does 4*rep*d flops per visible token, far
// below the ~295 flops/byte needed to reach the tensor-core limit, so the
// least time is the visible K/V bytes over 3.35 TB/s.  The design keeps
// the fp32 softmax state, q and the scores in shared memory and streams
// K and V from device memory exactly once per (row, kv head), walking only
// the visible pages (the row's length bounds both traffic and work).  A
// loop trip stages pages_per_step pages; both the score pass and the PV
// pass split the trip's tokens over the CTA's 8 warps, each warp keeping
// 4 K or V rows in flight (a thread walking tokens one by one was
// latency-bound), with per-warp fp32 partial sums added once at the end.
//
// Simple design, left on the table for later work:
//   - one CTA per (row, kv head): a decode batch of 8 sequences x 8 kv
//     heads fills 64 of the 132 SMs, and a long sequence is not split
//     across CTAs (no split-K);
//   - fp32 CUDA-core dot products, no wgmma, no TMA or cp.async staging;
//   - in the ragged mode a prefill row re-reads its sequence's pages once
//     per row (L2 catches part of it); a multi-row q tile per sequence
//     would read them once.
//
// Semantics kept from the TPU kernels (tests/test_flash_decoding.py):
//   - masking with NEG_INF = -1e30, never -inf;
//   - a row that sees no key outputs exactly 0 (valid = m > NEG_INF/2,
//     l == 0 -> 1);
//   - K/V rows past the visible length never enter the sums, so garbage
//     or NaN there (the trash page, unwritten cache) cannot poison them;
//   - the logical page index clamps to the row's last visible page and to
//     max_pages - 1; table entries of -1 clamp to page 0; the walk covers
//     ceil(max_pages / pp) * pp logical pages, as the TPU grid does;
//   - ragged rows with slot < 0 are padding: length 0, output 0;
//   - GQA is group-major: q head kv*rep + r reads kv head kv;
//   - scale multiplies the fp32 dot; p is rounded to v's dtype (after the
//     int8 widening, q's dtype) before the PV product, whose sum is fp32;
//   - int8 K/V are widened to q's dtype in the kernel; the dequant scales
//     stay with the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // K/V rows a warp loads before it uses them
constexpr int kHeadChunk = 8;  // q heads accumulated in registers per PV pass

enum DTypeCode { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
// int8 -> q's dtype is exact for |x| <= 127 in both fp32 and bf16
__device__ __forceinline__ float widen(int8_t x) { return static_cast<float>(x); }

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

struct Args {
  const void* q;       // [rows, h, d]
  const void* k;       // dense [rows, kvh, t_max, d] | paged [n_pages, kvh, page, d]
  const void* v;
  void* o;             // [rows, h, d], q's dtype
  const int* lens;     // [rows] visible length
  const int* slots;    // [rows] page-table row (ragged) or nullptr (row == slot)
  const int* tables;   // [slots, max_pages] physical page ids (paged only)
  int h, kvh, rep;
  int t_max;           // dense: cache rows per sequence
  int page;            // paged: tokens per page
  int max_pages;       // paged: table width
  int pp;              // paged: pages staged per loop trip
  int trips;           // paged: ceil(max_pages / pp)
  int tile;            // tokens per loop trip (pp * page when paged)
  float scale;
};

template <typename TQ, typename TKV, int D, bool PAGED>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  using TP = typename PvType<TQ, TKV>::type;
  constexpr int kCols = (D + 31) / 32;  // elements of a K/V row per lane
  extern __shared__ float smem[];
  const int rep = a.rep;
  float* q_s = smem;                    // [rep][D] fp32 q
  float* acc_s = q_s + rep * D;         // [kWarps][rep][D] per-warp fp32 sums
  float* s_s = acc_s + kWarps * rep * D;  // [rep][tile] scores, then p
  float* m_s = s_s + rep * a.tile;      // [rep] running max
  float* l_s = m_s + rep;               // [rep] running sum
  float* alpha_s = l_s + rep;           // [rep] rescale of this trip
  int* phys_s = reinterpret_cast<int*>(alpha_s + rep);  // [pp] pages of this trip

  const int row = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int len = a.lens[row];
  int slot = row;
  if (PAGED) {
    if (a.slots != nullptr) {
      slot = a.slots[row];
      if (slot < 0) {  // padding row: visibility 0, output forced to 0
        slot = 0;
        len = 0;
      }
    }
  } else {
    len = min(len, a.t_max);
  }
  len = max(len, 0);

  const TQ* q = static_cast<const TQ*>(a.q) + (static_cast<size_t>(row) * a.h + static_cast<size_t>(g) * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = widen(q[i]);
  for (int i = tid; i < kWarps * rep * D; i += kThreads) acc_s[i] = 0.f;
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const TKV* kc = static_cast<const TKV*>(a.k);
  const TKV* vc = static_cast<const TKV*>(a.v);
  int last = 0;  // last visible logical page, clamped to the table width
  if (PAGED) {
    last = max((len + a.page - 1) / a.page - 1, 0);
    last = min(last, a.max_pages - 1);
  }
  const size_t dense_base = (static_cast<size_t>(row) * a.kvh + g) * static_cast<size_t>(a.t_max);
  // element offset of token t of the trip starting at position start (a
  // trip starts on a page boundary, so t / page indexes its staged pages)
  auto row_offset = [&](int start, int t) -> size_t {
    if (PAGED) {
      const size_t phys = static_cast<size_t>(phys_s[t / a.page]);
      return ((phys * a.kvh + g) * a.page + (t % a.page)) * D;
    }
    return (dense_base + start + t) * D;
  };
  float* acc_w = acc_s + warp * rep * D;

  const int trips = PAGED ? a.trips : (len + a.tile - 1) / a.tile;
  for (int trip = 0; trip < trips; ++trip) {
    const int start = trip * a.tile;
    if (start >= len) break;  // trips past the visible length do no work
    const int n = min(a.tile, len - start);  // visible tokens of this trip
    __syncthreads();  // previous trip's readers of phys_s / s_s are done
    if (PAGED) {
      for (int j = tid; j < a.pp; j += kThreads) {
        const int li = min(trip * a.pp + j, last);
        phys_s[j] = max(a.tables[static_cast<size_t>(slot) * a.max_pages + li], 0);
      }
      __syncthreads();
    }

    // scores: each warp loads kUnroll visible K rows (lanes split d) before
    // it reduces them, so several rows are in flight per warp
    for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
      float kr[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const TKV* krow = kc + row_offset(start, min(t0 + u, n - 1));
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = lane + 32 * c;
          kr[u][c] = (i < D) ? widen(krow[i]) : 0.f;
        }
      }
      for (int r = 0; r < rep; ++r) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int i = lane + 32 * c;
            if (i < D) part += q_s[r * D + i] * kr[u][c];
          }
          part = warp_sum(part);
          if (lane == 0 && t0 + u < n) s_s[r * a.tile + t0 + u] = part * a.scale;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per q head
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s_s[r * a.tile + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(s_s[r * a.tile + t] - m_new);
        sum += p;
        s_s[r * a.tile + t] = round_to(p, static_cast<TP*>(nullptr));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // PV: warps split the trip's tokens (kUnroll V rows in flight each),
    // lanes split d; each warp keeps its own partial sums, summed at the end
    for (int r0 = 0; r0 < rep; r0 += kHeadChunk) {
      float acc[kHeadChunk][kCols];
#pragma unroll
      for (int rr = 0; rr < kHeadChunk; ++rr) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = lane + 32 * c;
          acc[rr][c] = (r0 + rr < rep && i < D) ? acc_w[(r0 + rr) * D + i] * alpha_s[r0 + rr] : 0.f;
        }
      }
      for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
        float vr[kUnroll][kCols];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const TKV* vrow = vc + row_offset(start, min(t0 + u, n - 1));
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int i = lane + 32 * c;
            vr[u][c] = (i < D) ? widen(vrow[i]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u >= n) break;
#pragma unroll
          for (int rr = 0; rr < kHeadChunk; ++rr) {
            if (r0 + rr < rep) {
              const float p = s_s[(r0 + rr) * a.tile + t0 + u];
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[rr][c] += p * vr[u][c];
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kHeadChunk; ++rr) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int i = lane + 32 * c;
          if (r0 + rr < rep && i < D) acc_w[(r0 + rr) * D + i] = acc[rr][c];
        }
      }
    }
  }
  __syncthreads();

  TQ* o = static_cast<TQ*>(a.o) + (static_cast<size_t>(row) * a.h + static_cast<size_t>(g) * rep) * D;
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += acc_s[w * rep * D + idx];
    float l = l_s[r];
    if (l == 0.f) l = 1.f;
    const bool valid = m_s[r] > kNegInf * 0.5f;
    store(o + idx, valid ? sum / l : 0.f);
  }
}

template <typename TQ, typename TKV, int D, bool PAGED>
cudaError_t launch(const Args& a, int rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((1 + kWarps) * static_cast<size_t>(a.rep) * D +
                                       static_cast<size_t>(a.rep) * a.tile + 3 * a.rep) +
                      sizeof(int) * (PAGED ? a.pp : 0);
  auto kernel = decode_attention_kernel<TQ, TKV, D, PAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(rows, a.kvh);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t dispatch_d(const Args& a, int rows, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<TQ, TKV, 8, PAGED>(a, rows, stream);
    case 16: return launch<TQ, TKV, 16, PAGED>(a, rows, stream);
    case 32: return launch<TQ, TKV, 32, PAGED>(a, rows, stream);
    case 64: return launch<TQ, TKV, 64, PAGED>(a, rows, stream);
    case 128: return launch<TQ, TKV, 128, PAGED>(a, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int dispatch(const Args& a, int rows, int d, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32) return dispatch_d<float, float, PAGED>(a, rows, d, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16) return dispatch_d<__nv_bfloat16, __nv_bfloat16, PAGED>(a, rows, d, s);
  if (q_dtype == kF32 && kv_dtype == kI8) return dispatch_d<float, int8_t, PAGED>(a, rows, d, s);
  // an fp32 model over a bf16 cache (an int8-weight dict serves on bf16 pools)
  if (q_dtype == kF32 && kv_dtype == kBF16) return dispatch_d<float, __nv_bfloat16, PAGED>(a, rows, d, s);
  if (q_dtype == kBF16 && kv_dtype == kI8) return dispatch_d<__nv_bfloat16, int8_t, PAGED>(a, rows, d, s);
  return cudaErrorInvalidValue;
}

Args base_args(const void* q, const void* k, const void* v, void* o, const void* lens,
               int h, int kvh, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lens = static_cast<const int*>(lens);
  a.h = h;
  a.kvh = kvh;
  a.rep = h / kvh;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// flash_decode_raw: q [b, h, d]; k/v [b, kvh, t_max, d]; seq_lens [b] int32.
int pt_flash_decode(const void* q, const void* k, const void* v, void* o, const void* seq_lens,
                    int b, int h, int kvh, int t_max, int d, int tile, float scale,
                    int q_dtype, int kv_dtype, void* stream) {
  Args a = base_args(q, k, v, o, seq_lens, h, kvh, scale);
  a.t_max = t_max;
  a.tile = tile;
  return dispatch<false>(a, b, d, q_dtype, kv_dtype, stream);
}

// paged_decode_raw: q [b, h, d]; pools [n_pages, kvh, page, d]; seq_lens [b];
// block_tables [b, max_pages] (-1 = unused).
int pt_paged_decode(const void* q, const void* k, const void* v, void* o, const void* seq_lens,
                    const void* block_tables, int b, int h, int kvh, int page, int d,
                    int max_pages, int pp, float scale, int q_dtype, int kv_dtype, void* stream) {
  Args a = base_args(q, k, v, o, seq_lens, h, kvh, scale);
  a.slots = nullptr;
  a.tables = static_cast<const int*>(block_tables);
  a.page = page;
  a.max_pages = max_pages;
  a.pp = pp;
  a.trips = (max_pages + pp - 1) / pp;
  a.tile = pp * page;
  return dispatch<true>(a, b, d, q_dtype, kv_dtype, stream);
}

// ragged_paged_decode_raw: q [T, h, d] packed rows; row_lens [T]; row_slot [T]
// (< 0 = padding); block_tables [slots, max_pages].
int pt_ragged_paged_decode(const void* q, const void* k, const void* v, void* o,
                           const void* row_lens, const void* row_slot, const void* block_tables,
                           int rows, int h, int kvh, int page, int d, int max_pages, int pp,
                           float scale, int q_dtype, int kv_dtype, void* stream) {
  Args a = base_args(q, k, v, o, row_lens, h, kvh, scale);
  a.slots = static_cast<const int*>(row_slot);
  a.tables = static_cast<const int*>(block_tables);
  a.page = page;
  a.max_pages = max_pages;
  a.pp = pp;
  a.trips = (max_pages + pp - 1) / pp;
  a.tile = pp * page;
  return dispatch<true>(a, rows, d, q_dtype, kv_dtype, stream);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
