// Masked flash attention for Hopper (sm_90a): the per-head training forward
// and backward over compressed live-tile lists, with causal, segment-id and
// FlashMask band masks.  Plain C interface loaded through ctypes
// (paddle_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Replaces the Pallas TPU kernel bodies of the per-head path of
// paddle_tpu/ops/pallas/flash_attention.py:
//   - _flash_kernel (launcher _flash_forward, B5)        -> masked_fwd_wgmma_kernel
//       (bf16 at head dim 64 and 128, the wrapper's masked_fwd_route) and
//       masked_fwd_kernel (fp32, and bf16 at 16 and 32)
//   - _flash_bwd_fused_kernel (_flash_backward, B6)      -> masked_dkv_wgmma_kernel<fused>
//   - _flash_bwd_dq_kernel (_flash_backward, B6)         -> masked_dq_wgmma_kernel
//   - _flash_bwd_dkv_kernel (_flash_backward, B6)        -> masked_dkv_wgmma_kernel<split>
//       (bf16 at head dim 64 and 128, the wrapper's masked_bwd_route), and
//       masked_dkv_kernel<fused>, masked_dq_kernel, masked_dkv_kernel<split>
//       (fp32, and bf16 at 16 and 32)
//
// Layouts (as the TPU launchers'): q, o, do, dq [b*h, sq, d] with the heads
// of a GQA group adjacent (group-major), read here as [groups, rep, sq, d];
// k, v, dk, dv [groups, sk, d]; lse, delta [groups, rep, sq] fp32 (the TPU's
// 8-row broadcast is sublane padding and is dropped).  Masks: q_seg [b, sq]
// and k_seg [b, sk] int32 segment ids (a query sees a key iff the ids are
// equal); band [4, b * mask_h, sk] int32, the FlashMask row bands (lts, lte,
// uts, ute): key j hides rows [lts, lte) and [uts, ute); mask_h divides kvh.
//
// The live lists are the TPU's scalar-prefetch tables (_live_tables,
// _compress_live, computed by the wrapper at this kernel's tiles): for each
// gate row (batch entry x mask head) and outer tile, count = the number of
// inner tiles that can hold an unmasked pair, idx = their indices ascending.
// A CTA reads its count and list from global memory and loops over j < count
// only, so a dead tile costs neither a load nor a product.  The forward and
// the dq kernel walk k tiles per q tile; the dk/dv kernels walk the
// transposed list, q tiles per k tile.
//
// What bounds it on the H100: the VISIBLE (q, k) pairs only, 4 d flops per
// pair forward and 10 d backward, against reading q, k, v (and o, do) once.
// At the train shape (b 6, s 1024, 16 q heads over 4 kv heads, d 128,
// packed documents of median 256 tokens) a third of the causal triangle is
// visible and the bytes bound it; at 8K with documents of median 1024 the
// operations do.  The design:
//   - a shared-memory kernel's CTA covers hpc heads of one GQA group (hpc
//     divides rep, at most 4) at bq query positions: the live list depends only on (batch, mask
//     head, q tile), and a mask head spans whole groups, so every head of
//     the CTA shares it, and each K/V tile is staged once for hpc heads;
//   - the inner loop runs inside the CTA with the fp32 softmax state and
//     output tile in shared memory, as in csrc/flash_attention.cu;
//   - bf16 products on the tensor cores (wmma 16x16x16, fp32 accumulation),
//     fp32 on CUDA cores (flash_common.cuh);
//   - backward, fused route (the TPU's one pass): one CTA per (group, k
//     tile) walks the group's heads x live q tiles with 5 products per tile
//     pair, dk/dv summed over the group in shared memory, and dq summed
//     across CTAs with fp32 atomicAdd into a zeroed buffer, cast to q's
//     dtype by a second kernel (the TPU holds a full-sequence dk/dv scratch
//     instead, which shared memory cannot).  Atomics add in run order, so
//     two runs can differ at fp32 rounding in dq;
//   - backward, split route (where the TPU's scratch would not fit): a dq
//     kernel per (head chunk, q tile) over live k tiles, and a dk/dv kernel
//     per (group, k tile) over the group's heads x live q tiles, with the
//     group sum in shared memory: deterministic;
//   - delta = rowsum(do * o) comes from the caller, as the TPU launcher
//     computes it outside its kernels;
//   - B5 bf16 at d 64/128 (masked_fwd_wgmma_kernel) is B1's warp-specialised
//     forward (csrc/flash_attention.cu hb_fwd_wgmma_kernel) over the live
//     list: a producer warp keeps the live K/V tiles (64 keys) in flight by
//     TMA in a 3-stage mbarrier ring, with each tile's mask data (key ids,
//     band rows) staged beside it; two consumer warpgroups own 64 of the
//     CTA's 128 rows (hpc heads x 128 / hpc positions, hpc the largest
//     divisor of rep up to 8, so a K/V tile serves up to 8 heads), keep S,
//     the softmax state and O in registers and apply the mask per element
//     there.  The CTA's own live list (masked_fwd_wgmma_tiles) is built at
//     its tiles;
//   - B6 bf16 at d 64/128 is B2's warp-specialised backward
//     (hb_dq_wgmma_kernel, hb_dkv_wgmma_kernel) over the live lists, each
//     kernel at its own tiles (masked_bwd_wgmma_tiles): masked_dq_wgmma_kernel
//     walks a q tile's live k tiles (128 rows against 64 keys, B5's grid and
//     mask staging), masked_dkv_wgmma_kernel a k tile's live q tiles x head
//     chunks (128 keys against 64 rows, the keys' mask data resident, the
//     rows' beside each ring stage); the mask is applied per element in
//     registers, dk/dv and dq stay in registers.  The fused instantiation
//     also computes dq = ds K per tile pair from a ds^T tile the consumers
//     store in shared memory, and adds it into dq_acc by 16-byte vector
//     reductions (fp32 run order: two runs can differ at fp32 rounding);
//     the split pair stays deterministic.
// Left for later work: the fp32 / small-d kernels run wmma from shared
// memory with synchronous loads and the accumulator rescaled in shared
// memory; the wgmma kernels serialise their elementwise work and products
// inside a warpgroup (no ping-pong).
//
// Semantics kept from the TPU kernels (tests/test_torch_masked_flash.py):
//   - masking with NEG_INF = -1e30, never -inf: a row whose keys are all
//     masked keeps m = NEG_INF and ends with o = 0 and lse = +1e30, so the
//     backward's p = exp(s - lse) is 0 there; keys past sk read as 0;
//   - fp32 scores and softmax state; p rounded to v's dtype before PV; l sums
//     the unrounded p; ds rounded to k's dtype for dq, p to do's dtype for
//     dv, ds to q's dtype for dk; query rows past sq contribute nothing.

#include "flash_common.cuh"  // Mma, dtype helpers, warp reductions, kThreads
#include "hopper.cuh"        // TMA, mbarriers, wgmma

namespace {

struct MArgs {
  const void* q;       // [groups, rep, sq, d]
  const void* k;       // [groups, sk, d]
  const void* v;
  const void* dout;    // backward: do, q-shaped
  const float* lse;    // backward input, [groups, rep, sq]
  const float* delta;  // backward: rowsum(do * o), [groups, rep, sq]
  void* o;             // forward output, q-shaped
  float* lse_out;      // forward output, [groups, rep, sq]
  void* dq;
  float* dq_acc;       // fused route: fp32 dq sums, q-shaped, zeroed by the caller
  void* dk;
  void* dv;
  const int* q_seg;    // [batch, sq] or null
  const int* k_seg;    // [batch, sk] or null
  const int* band;     // [4, batch * mask_h, sk] or null
  const int* count;    // live list: [gates, n_outer]
  const int* idx;      // [gates, n_outer, n_inner]
  int batch, kvh, rep, hpc;  // hpc: q heads per CTA, divides rep
  int sq, sk, bq, bk;        // bq query positions and bk keys per tile
  int mask_h, gate_h;        // band rows / live-list rows per batch entry
  int n_outer, n_inner;
  int causal;
  float scale;
};

// Gate row of the live list and band row of group g (batch g / kvh, kv head
// g % kvh): mask head = kv head / (kvh / rows per batch entry).
__device__ __forceinline__ int gate_row(const MArgs& a, int g) {
  return (g / a.kvh) * a.gate_h + (g % a.kvh) / (a.kvh / a.gate_h);
}
__device__ __forceinline__ int band_row(const MArgs& a, int g) {
  return (g / a.kvh) * a.mask_h + (g % a.kvh) / (a.kvh / a.mask_h);
}

// rows x D elements into shared memory (leading dimension D + kPad): row r
// is head r / per_head at position pos0 + r % per_head of `base` (head
// stride limit * D); positions at or past `limit` are zero.  16-byte copies.
template <typename T, int D>
__device__ void load_rows(T* dst, const T* base, int rows, int per_head, int pos0, int limit) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = D / V;
  for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const int pos = pos0 + r % per_head;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < limit)
      val = *reinterpret_cast<const uint4*>(
          base + (static_cast<size_t>(r / per_head) * limit + pos) * D + c * V);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c * V) = val;
  }
}

// The mask data of bq query positions from q0 (segment ids) and of bk keys
// from k0 (segment ids, the four band bounds); past the sequence: 0.
__device__ void load_mask(int* qseg_s, int* kseg_s, int* band_s, const MArgs& a, int g,
                          int q0, int k0, bool queries, bool keys) {
  const int b = g / a.kvh;
  if (queries && a.q_seg != nullptr)
    for (int r = threadIdx.x; r < a.bq; r += kThreads)
      qseg_s[r] = q0 + r < a.sq ? a.q_seg[static_cast<size_t>(b) * a.sq + q0 + r] : 0;
  if (!keys) return;
  if (a.k_seg != nullptr)
    for (int j = threadIdx.x; j < a.bk; j += kThreads)
      kseg_s[j] = k0 + j < a.sk ? a.k_seg[static_cast<size_t>(b) * a.sk + k0 + j] : 0;
  if (a.band != nullptr) {
    const size_t stride = static_cast<size_t>(a.batch) * a.mask_h * a.sk;
    const size_t row = static_cast<size_t>(band_row(a, g)) * a.sk;
    for (int i = threadIdx.x; i < 4 * a.bk; i += kThreads) {
      const int c = i / a.bk, j = i % a.bk;
      band_s[i] = k0 + j < a.sk ? a.band[c * stride + row + k0 + j] : 0;
    }
  }
}

// Whether query position q_pos (index r in its tile) sees key k_pos (index j
// in its tile): in range, causal, same segment, outside both bands.
__device__ __forceinline__ bool keep(const MArgs& a, const int* qseg_s, const int* kseg_s,
                                     const int* band_s, int r, int q_pos, int j, int k_pos) {
  if (k_pos >= a.sk || (a.causal && q_pos < k_pos)) return false;
  if (a.q_seg != nullptr && qseg_s[r] != kseg_s[j]) return false;
  if (a.band != nullptr &&
      ((q_pos >= band_s[j] && q_pos < band_s[a.bk + j]) ||
       (q_pos >= band_s[2 * a.bk + j] && q_pos < band_s[3 * a.bk + j])))
    return false;
  return true;
}

// ---------------------------------------------------------------- B5 forward
// CTA (q tile, group x head chunk): M = hpc * bq rows, row m = head m / bq of
// the chunk at position q0 + m % bq; loops over the q tile's live k tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) masked_fwd_kernel(MArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.hpc * a.bq;
  const int ldd = D + kPad, ldk = a.bk + kPad;
  T* q_s = reinterpret_cast<T*>(smem);   // [M][ldd]
  T* k_s = q_s + M * ldd;                // [bk][ldd]
  T* v_s = k_s + a.bk * ldd;             // [bk][ldd]
  float* s_s = reinterpret_cast<float*>(v_s + a.bk * ldd);  // [M][ldk] fp32 scores
  T* p_s = reinterpret_cast<T*>(s_s + M * ldk);             // [M][ldk] p in v's dtype
  float* o_s = reinterpret_cast<float*>(p_s + M * ldk);     // [M][ldd] fp32 accumulator
  float* m_s = o_s + M * ldd;            // [M] running max
  float* l_s = m_s + M;                  // [M] running sum
  float* alpha_s = l_s + M;              // [M] rescale of this tile
  int* qseg_s = reinterpret_cast<int*>(alpha_s + M);  // [bq]
  int* kseg_s = qseg_s + a.bq;                        // [bk]
  int* band_s = kseg_s + a.bk;                        // [4][bk]

  const int chunks = a.rep / a.hpc;
  const int g = blockIdx.y / chunks, head0 = (blockIdx.y % chunks) * a.hpc;
  const int qi = blockIdx.x, q0 = qi * a.bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qoff = (static_cast<size_t>(g) * a.rep + head0) * a.sq * D;
  const T* kg = static_cast<const T*>(a.k) + static_cast<size_t>(g) * a.sk * D;
  const T* vg = static_cast<const T*>(a.v) + static_cast<size_t>(g) * a.sk * D;

  load_rows<T, D>(q_s, static_cast<const T*>(a.q) + qoff, M, a.bq, q0, a.sq);
  for (int i = tid; i < M * ldd; i += kThreads) o_s[i] = 0.f;
  for (int m = tid; m < M; m += kThreads) {
    m_s[m] = kNegInf;
    l_s[m] = 0.f;
  }
  load_mask(qseg_s, kseg_s, band_s, a, g, q0, 0, true, false);

  const size_t at = static_cast<size_t>(gate_row(a, g)) * a.n_outer + qi;
  const int cnt = a.count[at];
  const int* live = a.idx + at * a.n_inner;
  for (int jt = 0; jt < cnt; ++jt) {
    const int k0 = live[jt] * a.bk;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s and the mask are done
    load_rows<T, D>(k_s, kg, a.bk, a.bk, k0, a.sk);
    load_rows<T, D>(v_s, vg, a.bk, a.bk, k0, a.sk);
    load_mask(qseg_s, kseg_s, band_s, a, g, q0, k0, false, true);
    __syncthreads();
    Mma<T>::abt(s_s, ldk, q_s, ldd, k_s, ldd, M, a.bk, D);
    __syncthreads();

    // online softmax: one warp per row, lanes over the tile's keys
    for (int m = warp; m < M; m += kWarps) {
      const int r = m % a.bq, q_pos = q0 + r;
      float* srow = s_s + m * ldk;
      float mx = kNegInf;
      for (int j = lane; j < a.bk; j += 32) {
        const float s = keep(a, qseg_s, kseg_s, band_s, r, q_pos, j, k0 + j)
                            ? srow[j] * a.scale : kNegInf;
        srow[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[m];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < a.bk; j += 32) {
        const float p = expf(srow[j] - m_new);
        sum += p;
        p_s[m * ldk + j] = from_f<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[m] = alpha;
        l_s[m] = l_s[m] * alpha + sum;
        m_s[m] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < M * D; i += kThreads) o_s[(i / D) * ldd + i % D] *= alpha_s[i / D];
    __syncthreads();
    Mma<T>::ab_acc(o_s, ldd, p_s, ldk, v_s, ldd, M, D, a.bk);
  }
  __syncthreads();

  T* og = static_cast<T*>(a.o) + qoff;
  for (int i = tid; i < M * D; i += kThreads) {
    const int m = i / D, c = i % D;
    const int pos = q0 + m % a.bq;
    if (pos >= a.sq) continue;
    float l = l_s[m];
    if (l == 0.f) l = 1.f;
    const bool valid = m_s[m] > kNegInf * 0.5f;
    og[(static_cast<size_t>(m / a.bq) * a.sq + pos) * D + c] =
        from_f<T>(valid ? o_s[m * ldd + c] / l : 0.f);
  }
  for (int m = tid; m < M; m += kThreads) {
    const int pos = q0 + m % a.bq;
    if (pos >= a.sq) continue;
    float l = l_s[m];
    if (l == 0.f) l = 1.f;
    const bool valid = m_s[m] > kNegInf * 0.5f;
    a.lse_out[(static_cast<size_t>(g) * a.rep + head0 + m / a.bq) * a.sq + pos] =
        valid ? m_s[m] + logf(l) : -kNegInf;
  }
}

// ------------------------------------------------- B5 forward, bf16 on wgmma
constexpr int kWRows = 128;     // rows of a CTA: two consumer warpgroups of 64
constexpr int kWBK = 64;        // keys per k tile
constexpr int kWStages = 3;     // K/V ring depth
// two consumer warpgroups, then a producer warpgroup of which warp 8 loads:
// the producer gives its registers back (setmaxnreg) so that each consumer
// thread can hold up to kWConsumerRegs (the cap of a 384-thread CTA is 168)
constexpr int kWThreads = 384;
constexpr int kWProducerRegs = 40, kWConsumerRegs = 232;
constexpr int kPanel = 128;     // bytes of one row of a 64-column panel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of masked_fwd_wgmma_kernel: q [D/64 panels][128 rows][64],
// then per stage k and v [D/64 panels][kWBK rows][64]; 1024 bytes of slack
// align the tiles to the swizzle atom.
template <int D>
struct MaskedWgmmaSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kQPanel = kWRows * kPanel;
  static constexpr int kKVPanel = kWBK * kPanel;
  static constexpr int kTile = kPanels * kKVPanel;  // one k or v tile
  static constexpr int kBytes = kPanels * kQPanel + 2 * kWStages * kTile + 1024;
};

// One CTA per (q tile, group, head chunk): 128 rows = hpc heads x bq
// positions of one GQA group (rows past hpc * bq idle, never loaded or
// stored), q tiles longest first.  The q tile's live k-tile list
// (count / idx at gate_row) is read from device memory; a CTA with an empty
// list writes o = 0, lse = +1e30 and issues no load.  Warp 8 is the
// producer: one TMA load of the q tile (a 4-D box (64, bq, hpc, 1) per
// panel at (0, q0, head0, g), zero past sq), then each live k tile's K and V
// through a kWStages ring of mbarriers, with the tile's first key and mask
// data (64 key segment ids, the 4 band rows) written beside the stage by
// the producer warp's 32 lanes.  Warpgroups 0 and 1 each own 64 rows: S = Q
// K^T (wgmma, K-major operands from shared memory, S in registers), the
// mask applied per element in registers by keep()'s rule, the online
// softmax in registers, p rounded to bf16 in registers as the A operand of
// O += P V (V MN-major from shared memory, not transposed in memory).
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
    masked_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, MArgs a, int groups) {
  using L = MaskedWgmmaSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kWStages];
  __shared__ int st_k0[kWStages];                 // first key of the staged tile
  __shared__ __align__(8) int st_mask[kWStages][5][kWBK];  // key ids, lts, lte, uts, ute
  unsigned char* q_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* kv_s = q_s + L::kPanels * L::kQPanel;  // stage s: k, then v
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kWStages;

  const int chunks = a.rep / a.hpc;
  const int per_tile = groups * chunks;  // CTAs of one q tile
  const int unit = static_cast<int>(blockIdx.x) % per_tile;
  const int g = unit / chunks, head0 = (unit % chunks) * a.hpc;
  const int qi = a.n_outer - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int q0 = qi * a.bq;
  const size_t at = static_cast<size_t>(gate_row(a, g)) * a.n_outer + qi;
  const int cnt = a.count[at];
  const int bi = g / a.kvh;  // batch entry
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kWProducerRegs>();
    if (warp > 8 || cnt == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, L::kPanels * kPanel * a.bq * a.hpc);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_4d(q_s + p * L::kQPanel, &tq, q_full, p * 64, q0, head0, g);
    }
    const int* live = a.idx + at * a.n_inner;
    const size_t bstride = static_cast<size_t>(a.batch) * a.mask_h * a.sk;
    const size_t brow = static_cast<size_t>(band_row(a, g)) * a.sk;
    for (int jt = 0; jt < cnt; ++jt) {
      const int s = jt % kWStages;
      const int k0 = live[jt] * kWBK;
      mbar_wait(&empty[s], ((jt / kWStages) & 1) ^ 1);
      for (int j = lane; j < kWBK; j += 32) {
        const int kp = k0 + j;
        const bool in = kp < a.sk;
        if (a.k_seg != nullptr)
          st_mask[s][0][j] = in ? a.k_seg[static_cast<size_t>(bi) * a.sk + kp] : 0;
        if (a.band != nullptr)
          for (int c = 0; c < 4; ++c)
            st_mask[s][1 + c][j] = in ? a.band[c * bstride + brow + kp] : 0;
      }
      if (lane == 0) {
        st_k0[s] = k0;
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        unsigned char* k_dst = kv_s + s * 2 * L::kTile;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(k_dst + p * L::kKVPanel, &tk, &full[s], p * 64, k0, g);
          tma_load_3d(k_dst + L::kTile + p * L::kKVPanel, &tv, &full[s], p * 64, k0, g);
        }
      } else {
        mbar_arrive(&full[s]);  // the mask data written above is released
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kWConsumerRegs>();
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  // this thread's two rows of the accumulator layout (j = 0, 1: +8 rows),
  // with their query segment ids, read once
  int head[2], pos[2], qid[2];
  bool row_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = wg * 64 + wq * 16 + lane / 4 + 8 * j;
    head[j] = head0 + m / a.bq;
    pos[j] = q0 + m % a.bq;
    row_ok[j] = m < a.hpc * a.bq && pos[j] < a.sq;  // rows past hpc * bq are never loaded
    qid[j] = (a.q_seg != nullptr && row_ok[j]) ? a.q_seg[static_cast<size_t>(bi) * a.sq + pos[j]]
                                               : 0;
  }
  const bool seg = a.q_seg != nullptr, bands = a.band != nullptr;
  float o[L::kPanels][32];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  // running max in log2 units (scores times scale * log2 e) and this
  // thread's share of the running sum (the 4 threads of a row add up at the end)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;

  if (cnt > 0) mbar_wait(q_full, 0);
  for (int jt = 0; jt < cnt; ++jt) {
    const int s = jt % kWStages;
    const unsigned char* k_s = kv_s + s * 2 * L::kTile;
    const unsigned char* v_s = k_s + L::kTile;
    mbar_wait(&full[s], (jt / kWStages) & 1);
    const int k0 = st_k0[s];

    // S = Q K^T over D in k steps of 16: panel ks / 4, 32 bytes per step
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int p = ks / 4, j = ks % 4;
      const uint64_t da = smem_desc(q_s + p * L::kQPanel + wg * 64 * kPanel + j * 32, 16, 1024);
      const uint64_t db = smem_desc(k_s + p * L::kKVPanel + j * 32, 16, 1024);
      wgmma_ss_n64<0, 0>(sc, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the mask per element (keep()'s rule): value i sits in row j = (i / 2)
    // % 2 at column (i / 4) * 8 + (lane % 4) * 2 + i % 2; the two columns of
    // a pair share their mask loads
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int cg = 0; cg < 8; ++cg) {
      const int col = cg * 8 + (lane % 4) * 2;
      int2 kid = make_int2(0, 0), lts = kid, lte = kid, uts = kid, ute = kid;
      if (seg) kid = *reinterpret_cast<const int2*>(&st_mask[s][0][col]);
      if (bands) {
        lts = *reinterpret_cast<const int2*>(&st_mask[s][1][col]);
        lte = *reinterpret_cast<const int2*>(&st_mask[s][2][col]);
        uts = *reinterpret_cast<const int2*>(&st_mask[s][3][col]);
        ute = *reinterpret_cast<const int2*>(&st_mask[s][4][col]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = cg * 4 + e, j = e / 2, hi = e % 2;
        const int kp = k0 + col + hi;
        const int qp = pos[j];
        bool keep = kp < a.sk && (!a.causal || qp >= kp);
        if (seg) keep = keep && qid[j] == (hi ? kid.y : kid.x);
        if (bands) {
          const int b0 = hi ? lts.y : lts.x, b1 = hi ? lte.y : lte.x;
          const int b2 = hi ? uts.y : uts.x, b3 = hi ? ute.y : ute.x;
          keep = keep && !((qp >= b0 && qp < b1) || (qp >= b2 && qp < b3));
        }
        const float v = keep ? sc[i] * sl2 : kNegInf;
        sc[i] = v;
        mx[j] = fmaxf(mx[j], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m_run[j], mx[j]);
      alpha[j] = exp2f(m_run[j] - m_new);
      m_run[j] = m_new;
      l_run[j] *= alpha[j];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i / 2) % 2;
      const float p = exp2f(sc[i] - m_run[j]);
      l_run[j] += p;  // l sums the unrounded p
      sc[i] = p;
    }
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i / 2) % 2];

    // O += P V: p rounded to bf16 as the register A operand, V MN-major
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWBK / 16; ++ks) {
      const uint32_t af[4] = {pack_bf16(sc[8 * ks + 0], sc[8 * ks + 1]),
                              pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]),
                              pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]),
                              pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7])};
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        const uint64_t db = smem_desc(v_s + p * L::kKVPanel + ks * 16 * kPanel, L::kKVPanel, 1024);
        wgmma_rs_n64<1>(o[p], af, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) fence_regs(o[p]);
    mbar_arrive(&empty[s]);
  }

  // a row that saw no key (m still NEG_INF, also every row of an empty
  // list): o = 0 and lse = +1e30
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + static_cast<size_t>(g) * a.rep * a.sq * D;
  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l_run[j];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (l == 0.f) l = 1.f;
    const bool valid = m_run[j] > kNegInf * 0.5f;
    inv[j] = valid ? 1.f / l : 0.f;
    if (row_ok[j] && lane % 4 == 0)
      a.lse_out[(static_cast<size_t>(g) * a.rep + head[j]) * a.sq + pos[j]] =
          valid ? (m_run[j] + log2f(l)) * kLn2 : -kNegInf;
  }
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int j = (i / 2) % 2;
      if (!row_ok[j]) continue;
      const int c = p * 64 + (i / 4) * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(
          og + (static_cast<size_t>(head[j]) * a.sq + pos[j]) * D + c) =
          __floats2bfloat162_rn(o[p][i] * inv[j], o[p][i + 1] * inv[j]);
    }
}

// lse and delta of the M rows of a q tile (heads head0.. of group g); rows
// past sq read 0.
__device__ void load_row_stats(float* lse_s, float* delta_s, const MArgs& a, int g, int head0,
                               int q0) {
  const int M = a.hpc * a.bq;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const int pos = q0 + m % a.bq;
    const size_t at = (static_cast<size_t>(g) * a.rep + head0 + m / a.bq) * a.sq + pos;
    lse_s[m] = pos < a.sq ? a.lse[at] : 0.f;
    delta_s[m] = pos < a.sq ? a.delta[at] : 0.f;
  }
}

// p and ds of one score tile (s_s holds q.k, dp_s holds do.v): p = exp(s -
// lse) masked, ds = p * (dp - delta) * scale, both zero on rows past sq and
// ds zero on keys past sk.  Writes p (if p_s is given) and ds, rounded to T.
template <typename T>
__device__ void p_and_ds(const float* s_s, const float* dp_s, T* p_s, T* ds_s,
                         const float* lse_s, const float* delta_s, const int* qseg_s,
                         const int* kseg_s, const int* band_s, const MArgs& a, int q0, int k0) {
  const int M = a.hpc * a.bq;
  const int ldk = a.bk + kPad;
  for (int i = threadIdx.x; i < M * a.bk; i += kThreads) {
    const int m = i / a.bk, j = i % a.bk;
    const int r = m % a.bq, q_pos = q0 + r, k_pos = k0 + j;
    const float s = keep(a, qseg_s, kseg_s, band_s, r, q_pos, j, k_pos)
                        ? s_s[m * ldk + j] * a.scale : kNegInf;
    float p = expf(s - lse_s[m]);
    float ds = p * (dp_s[m * ldk + j] - delta_s[m]) * a.scale;
    if (q_pos >= a.sq) p = ds = 0.f;
    if (k_pos >= a.sk) ds = 0.f;
    if (p_s != nullptr) p_s[m * ldk + j] = from_f<T>(p);
    ds_s[m * ldk + j] = from_f<T>(ds);
  }
}

// --------------------------------------------- B6 dq (split route), per q tile
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) masked_dq_kernel(MArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.hpc * a.bq;
  const int ldd = D + kPad, ldk = a.bk + kPad;
  T* q_s = reinterpret_cast<T*>(smem);   // [M][ldd]
  T* do_s = q_s + M * ldd;               // [M][ldd]
  T* k_s = do_s + M * ldd;               // [bk][ldd]
  T* v_s = k_s + a.bk * ldd;             // [bk][ldd]
  float* s_s = reinterpret_cast<float*>(v_s + a.bk * ldd);  // [M][ldk]
  float* dp_s = s_s + M * ldk;                              // [M][ldk]
  T* ds_s = reinterpret_cast<T*>(dp_s + M * ldk);           // [M][ldk] ds in k's dtype
  float* dq_s = reinterpret_cast<float*>(ds_s + M * ldk);   // [M][ldd]
  float* lse_s = dq_s + M * ldd;                            // [M]
  float* delta_s = lse_s + M;                               // [M]
  int* qseg_s = reinterpret_cast<int*>(delta_s + M);        // [bq]
  int* kseg_s = qseg_s + a.bq;                              // [bk]
  int* band_s = kseg_s + a.bk;                              // [4][bk]

  const int chunks = a.rep / a.hpc;
  const int g = blockIdx.y / chunks, head0 = (blockIdx.y % chunks) * a.hpc;
  const int qi = blockIdx.x, q0 = qi * a.bq;
  const int tid = threadIdx.x;
  const size_t qoff = (static_cast<size_t>(g) * a.rep + head0) * a.sq * D;
  const size_t koff = static_cast<size_t>(g) * a.sk * D;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const T* vg = static_cast<const T*>(a.v) + koff;

  load_rows<T, D>(q_s, static_cast<const T*>(a.q) + qoff, M, a.bq, q0, a.sq);
  load_rows<T, D>(do_s, static_cast<const T*>(a.dout) + qoff, M, a.bq, q0, a.sq);
  load_row_stats(lse_s, delta_s, a, g, head0, q0);
  load_mask(qseg_s, kseg_s, band_s, a, g, q0, 0, true, false);
  for (int i = tid; i < M * ldd; i += kThreads) dq_s[i] = 0.f;

  const size_t at = static_cast<size_t>(gate_row(a, g)) * a.n_outer + qi;
  const int cnt = a.count[at];
  const int* live = a.idx + at * a.n_inner;
  for (int jt = 0; jt < cnt; ++jt) {
    const int k0 = live[jt] * a.bk;
    __syncthreads();  // the previous tile's readers of k_s, v_s, ds_s and the mask are done
    load_rows<T, D>(k_s, kg, a.bk, a.bk, k0, a.sk);
    load_rows<T, D>(v_s, vg, a.bk, a.bk, k0, a.sk);
    load_mask(qseg_s, kseg_s, band_s, a, g, q0, k0, false, true);
    __syncthreads();
    Mma<T>::abt(s_s, ldk, q_s, ldd, k_s, ldd, M, a.bk, D);
    Mma<T>::abt(dp_s, ldk, do_s, ldd, v_s, ldd, M, a.bk, D);
    __syncthreads();
    p_and_ds<T>(s_s, dp_s, static_cast<T*>(nullptr), ds_s, lse_s, delta_s, qseg_s, kseg_s,
                band_s, a, q0, k0);
    __syncthreads();
    Mma<T>::ab_acc(dq_s, ldd, ds_s, ldk, k_s, ldd, M, D, a.bk);
  }
  __syncthreads();

  T* dqg = static_cast<T*>(a.dq) + qoff;
  for (int i = tid; i < M * D; i += kThreads) {
    const int m = i / D, c = i % D;
    const int pos = q0 + m % a.bq;
    if (pos >= a.sq) continue;
    dqg[(static_cast<size_t>(m / a.bq) * a.sq + pos) * D + c] = from_f<T>(dq_s[m * ldd + c]);
  }
}

// ------------------------------ B6 dk/dv per k tile (split) and fused pass
// CTA (k tile, group): walks the transposed live list (the k tile's live q
// tiles), and for each every head chunk of the group; dk/dv of the whole
// group stay in shared memory.  kWithDq (the fused pass) adds dq = ds k per tile pair, summed
// across CTAs by atomicAdd into a.dq_acc.
template <typename T, int D, bool kWithDq>
__global__ void __launch_bounds__(kThreads) masked_dkv_kernel(MArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.hpc * a.bq;
  const int ldd = D + kPad, ldk = a.bk + kPad;
  // the fp32 dq tile of the fused pass reuses the score region once p and
  // ds are made: max(2 * M * ldk, M * ldd) floats
  const int score_floats = kWithDq ? max(2 * M * ldk, M * ldd) : 2 * M * ldk;
  T* q_s = reinterpret_cast<T*>(smem);   // [M][ldd]
  T* do_s = q_s + M * ldd;               // [M][ldd]
  T* k_s = do_s + M * ldd;               // [bk][ldd]
  T* v_s = k_s + a.bk * ldd;             // [bk][ldd]
  float* s_s = reinterpret_cast<float*>(v_s + a.bk * ldd);  // [M][ldk]
  float* dp_s = s_s + M * ldk;                              // [M][ldk]
  float* dq_s = s_s;                                        // fused: [M][ldd]
  T* p_s = reinterpret_cast<T*>(s_s + score_floats);        // [M][ldk] p in do's dtype
  T* ds_s = p_s + M * ldk;                                  // [M][ldk] ds in q's/k's dtype
  float* dk_s = reinterpret_cast<float*>(ds_s + M * ldk);   // [bk][ldd]
  float* dv_s = dk_s + a.bk * ldd;                          // [bk][ldd]
  float* lse_s = dv_s + a.bk * ldd;                         // [M]
  float* delta_s = lse_s + M;                               // [M]
  int* qseg_s = reinterpret_cast<int*>(delta_s + M);        // [bq]
  int* kseg_s = qseg_s + a.bq;                              // [bk]
  int* band_s = kseg_s + a.bk;                              // [4][bk]

  const int g = blockIdx.y;
  const int ki = blockIdx.x, k0 = ki * a.bk;
  const int tid = threadIdx.x;
  const size_t koff = static_cast<size_t>(g) * a.sk * D;

  load_rows<T, D>(k_s, static_cast<const T*>(a.k) + koff, a.bk, a.bk, k0, a.sk);
  load_rows<T, D>(v_s, static_cast<const T*>(a.v) + koff, a.bk, a.bk, k0, a.sk);
  load_mask(qseg_s, kseg_s, band_s, a, g, 0, k0, false, true);
  for (int i = tid; i < 2 * a.bk * ldd; i += kThreads) dk_s[i] = 0.f;  // dk_s and dv_s

  const size_t at = static_cast<size_t>(gate_row(a, g)) * a.n_outer + ki;
  const int cnt = a.count[at];
  const int* live = a.idx + at * a.n_inner;
  for (int jt = 0; jt < cnt; ++jt) {
    const int q0 = live[jt] * a.bq;
    for (int head0 = 0; head0 < a.rep; head0 += a.hpc) {
      const size_t qoff = (static_cast<size_t>(g) * a.rep + head0) * a.sq * D;
      __syncthreads();  // the previous tile's readers of q_s, do_s, p_s, ds_s, dq_s are done
      load_rows<T, D>(q_s, static_cast<const T*>(a.q) + qoff, M, a.bq, q0, a.sq);
      load_rows<T, D>(do_s, static_cast<const T*>(a.dout) + qoff, M, a.bq, q0, a.sq);
      load_row_stats(lse_s, delta_s, a, g, head0, q0);
      load_mask(qseg_s, kseg_s, band_s, a, g, q0, k0, true, false);
      __syncthreads();
      Mma<T>::abt(s_s, ldk, q_s, ldd, k_s, ldd, M, a.bk, D);
      Mma<T>::abt(dp_s, ldk, do_s, ldd, v_s, ldd, M, a.bk, D);
      __syncthreads();
      p_and_ds<T>(s_s, dp_s, p_s, ds_s, lse_s, delta_s, qseg_s, kseg_s, band_s, a, q0, k0);
      __syncthreads();
      if (kWithDq)
        for (int i = tid; i < M * ldd; i += kThreads) dq_s[i] = 0.f;
      // the contraction runs over all M rows: the sum over the chunk's heads
      Mma<T>::atb_acc(dv_s, ldd, p_s, ldk, do_s, ldd, a.bk, D, M);
      Mma<T>::atb_acc(dk_s, ldd, ds_s, ldk, q_s, ldd, a.bk, D, M);
      if (kWithDq) {
        __syncthreads();
        Mma<T>::ab_acc(dq_s, ldd, ds_s, ldk, k_s, ldd, M, D, a.bk);
        __syncthreads();
        for (int i = tid; i < M * D; i += kThreads) {
          const int m = i / D, c = i % D;
          const int pos = q0 + m % a.bq;
          if (pos < a.sq)
            atomicAdd(a.dq_acc + qoff + (static_cast<size_t>(m / a.bq) * a.sq + pos) * D + c,
                      dq_s[m * ldd + c]);
        }
      }
    }
  }
  __syncthreads();

  T* dkg = static_cast<T*>(a.dk) + koff;
  T* dvg = static_cast<T*>(a.dv) + koff;
  for (int i = tid; i < a.bk * D; i += kThreads) {
    const int j = i / D, c = i % D;
    if (k0 + j >= a.sk) continue;
    dkg[static_cast<size_t>(k0 + j) * D + c] = from_f<T>(dk_s[j * ldd + c]);
    dvg[static_cast<size_t>(k0 + j) * D + c] = from_f<T>(dv_s[j * ldd + c]);
  }
}

// fp32 dq sums -> q's dtype (the fused route's last step)
template <typename T>
__global__ void cast_kernel(const float* src, T* dst, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    dst[i] = from_f<T>(src[i]);
}

// ------------------------------------------------ B6 backward, bf16 on wgmma
// Shared memory of the two B6 wgmma kernels: the CTA's resident pair
// [D/64 panels][128 rows][64] (dq: q and do; dk/dv: k and v), then per
// stage the ringed pair [D/64 panels][64 rows][64] (dq: k and v; dk/dv: q
// and do).  dk/dv adds each consumer thread's fp32 p of the current q tile
// (32 values, 32 KB for the CTA) and, fused, two bf16 ds^T tiles [128
// keys][64 rows] (one written while the other may still be read).  The
// fused pass rings 2 stages so that all of it fits; 1024 bytes of slack
// align the tiles.
template <int D>
struct MaskedBwdSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kBig = kWRows * kPanel;   // one panel of a resident tile
  static constexpr int kSmall = kWBK * kPanel;   // one panel of a ringed tile
  static constexpr int kResident = 2 * kPanels * kBig;
  static constexpr int kStage = 2 * kPanels * kSmall;
  static constexpr int kP = 2 * 128 * 32 * 4;
  static constexpr int kDs = kWRows * kPanel;
  static constexpr int kDqBytes = kResident + kWStages * kStage + 1024;
  static constexpr int kFusedStages = 2;
  static constexpr int dkv_bytes(bool fused) {
    return kResident + (fused ? kFusedStages : kWStages) * kStage + kP + (fused ? 2 * kDs : 0) +
           1024;
  }
};

// dq per q tile (the split route's _flash_bwd_dq_kernel).  One CTA per (q
// tile, group, head chunk): 128 rows = hpc heads x bq positions, q tiles
// longest first; masked_fwd_wgmma_kernel's grid and live list.  Warp 8 is
// the producer: one TMA load of the q and do tiles (4-D boxes (64, bq, hpc,
// 1), zero past sq), then each live k tile's K and V (64 keys) through a
// kWStages ring, with the tile's first key and mask data written beside the
// stage by the producer warp's 32 lanes.  Warpgroup w owns rows w*64..: S =
// q k^T and dP = do v^T (wgmma, K-major operands from shared memory), the
// mask per element in registers, p = exp2(s * scale * log2 e - lse2) and ds
// = p (dP - delta) scale, ds rounded to bf16 as the register A operand of
// dq += ds k (k MN-major).  dq stays in registers and is written once:
// deterministic.  An empty list loads nothing and writes dq = 0.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
    masked_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, MArgs a, int groups) {
  using L = MaskedBwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kWStages];
  __shared__ int st_k0[kWStages];
  __shared__ __align__(8) int st_mask[kWStages][5][kWBK];  // key ids, lts, lte, uts, ute
  unsigned char* q_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* do_s = q_s + L::kPanels * L::kBig;
  unsigned char* kv_s = q_s + L::kResident;  // stage s: k, then v
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kWStages;

  const int chunks = a.rep / a.hpc;
  const int per_tile = groups * chunks;
  const int unit = static_cast<int>(blockIdx.x) % per_tile;
  const int g = unit / chunks, head0 = (unit % chunks) * a.hpc;
  const int qi = a.n_outer - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int q0 = qi * a.bq;
  const size_t at = static_cast<size_t>(gate_row(a, g)) * a.n_outer + qi;
  const int cnt = a.count[at];
  const int bi = g / a.kvh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kWProducerRegs>();
    if (warp > 8 || cnt == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::kPanels * kPanel * a.bq * a.hpc);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_4d(q_s + p * L::kBig, &tq, q_full, p * 64, q0, head0, g);
        tma_load_4d(do_s + p * L::kBig, &tdo, q_full, p * 64, q0, head0, g);
      }
    }
    const int* live = a.idx + at * a.n_inner;
    const size_t bstride = static_cast<size_t>(a.batch) * a.mask_h * a.sk;
    const size_t brow = static_cast<size_t>(band_row(a, g)) * a.sk;
    for (int kt = 0; kt < cnt; ++kt) {
      const int s = kt % kWStages;
      const int k0 = live[kt] * kWBK;
      mbar_wait(&empty[s], ((kt / kWStages) & 1) ^ 1);
      for (int j = lane; j < kWBK; j += 32) {
        const int kp = k0 + j;
        const bool in = kp < a.sk;
        if (a.k_seg != nullptr)
          st_mask[s][0][j] = in ? a.k_seg[static_cast<size_t>(bi) * a.sk + kp] : 0;
        if (a.band != nullptr)
          for (int c = 0; c < 4; ++c)
            st_mask[s][1 + c][j] = in ? a.band[c * bstride + brow + kp] : 0;
      }
      if (lane == 0) {
        st_k0[s] = k0;
        mbar_arrive_expect_tx(&full[s], L::kStage);
        unsigned char* k_dst = kv_s + s * L::kStage;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(k_dst + p * L::kSmall, &tk, &full[s], p * 64, k0, g);
          tma_load_3d(k_dst + (L::kPanels + p) * L::kSmall, &tv, &full[s], p * 64, k0, g);
        }
      } else {
        mbar_arrive(&full[s]);  // the mask data written above is released
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kWConsumerRegs>();
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  // this thread's two rows of the accumulator layout (j = 0, 1: +8 rows),
  // with their query ids, lse in log2 units and delta; rows past hpc * bq
  // (never loaded) and past sq get p = ds = 0 and are never stored
  int head[2], pos[2], qid[2];
  bool row_ok[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = wg * 64 + wq * 16 + lane / 4 + 8 * j;
    head[j] = head0 + m / a.bq;
    pos[j] = q0 + m % a.bq;
    row_ok[j] = m < a.hpc * a.bq && pos[j] < a.sq;
    const size_t r = (static_cast<size_t>(g) * a.rep + head[j]) * a.sq + pos[j];
    lse2[j] = row_ok[j] ? a.lse[r] * kLog2e : 0.f;
    dlt[j] = row_ok[j] ? a.delta[r] : 0.f;
    qid[j] = (a.q_seg != nullptr && row_ok[j]) ? a.q_seg[static_cast<size_t>(bi) * a.sq + pos[j]]
                                               : 0;
  }
  const bool seg = a.q_seg != nullptr, bands = a.band != nullptr;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  if (cnt > 0) mbar_wait(q_full, 0);
  for (int kt = 0; kt < cnt; ++kt) {
    const int s = kt % kWStages;
    const unsigned char* k_s = kv_s + s * L::kStage;
    const unsigned char* v_s = k_s + L::kPanels * L::kSmall;
    mbar_wait(&full[s], (kt / kWStages) & 1);
    const int k0 = st_k0[s];

    // S = q k^T and dP = do v^T over D in k steps of 16
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int p = ks / 4, j = ks % 4;
      const int row = p * L::kBig + wg * 64 * kPanel + j * 32;
      wgmma_ss_n64<0, 0>(sc, smem_desc(q_s + row, 16, 1024),
                         smem_desc(k_s + p * L::kSmall + j * 32, 16, 1024), ks > 0);
      wgmma_ss_n64<0, 0>(dp, smem_desc(do_s + row, 16, 1024),
                         smem_desc(v_s + p * L::kSmall + j * 32, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // the mask per element (keep()'s rule; value i in row j = (i / 2) % 2
    // at column (i / 4) * 8 + (lane % 4) * 2 + i % 2), then ds rounded to
    // bf16: the A operand of dq += ds k
    uint32_t af[16];
#pragma unroll
    for (int cg = 0; cg < 8; ++cg) {
      const int col = cg * 8 + (lane % 4) * 2;
      int2 kid = make_int2(0, 0), lts = kid, lte = kid, uts = kid, ute = kid;
      if (seg) kid = *reinterpret_cast<const int2*>(&st_mask[s][0][col]);
      if (bands) {
        lts = *reinterpret_cast<const int2*>(&st_mask[s][1][col]);
        lte = *reinterpret_cast<const int2*>(&st_mask[s][2][col]);
        uts = *reinterpret_cast<const int2*>(&st_mask[s][3][col]);
        ute = *reinterpret_cast<const int2*>(&st_mask[s][4][col]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = cg * 4 + 2 * j + hi;
          const int kp = k0 + col + hi, qp = pos[j];
          bool on = row_ok[j] && kp < a.sk && (!a.causal || qp >= kp);
          if (seg) on = on && qid[j] == (hi ? kid.y : kid.x);
          if (bands) {
            const int b0 = hi ? lts.y : lts.x, b1 = hi ? lte.y : lte.x;
            const int b2 = hi ? uts.y : uts.x, b3 = hi ? ute.y : ute.x;
            on = on && !((qp >= b0 && qp < b1) || (qp >= b2 && qp < b3));
          }
          const float p = on ? exp2f(sc[i] * sl2 - lse2[j]) : 0.f;
          ds[hi] = p * (dp[i] - dlt[j]) * a.scale;
        }
        af[cg * 2 + j] = pack_bf16(ds[0], ds[1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWBK / 16; ++ks) {
      const uint32_t a4[4] = {af[4 * ks], af[4 * ks + 1], af[4 * ks + 2], af[4 * ks + 3]};
      wgmma_rs_mn<D>(dq, a4, smem_desc(k_s + ks * 16 * kPanel, L::kSmall, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq) + static_cast<size_t>(g) * a.rep * a.sq * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int j = (i / 2) % 2;
    if (!row_ok[j]) continue;
    const int c = (i / 4) * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(dqg + (static_cast<size_t>(head[j]) * a.sq + pos[j]) * D +
                                       c) = __floats2bfloat162_rn(dq[i], dq[i + 1]);
  }
}

// dk and dv per k tile (the split route's _flash_bwd_dkv_kernel), and with
// kWithDq the fused pass (_flash_bwd_fused_kernel).  One CTA per (group,
// 128 keys); K, V and the keys' mask data (ids, band rows) are loaded once.
// Warp 8 is the producer: it walks the transposed live list (the k tile's
// live q tiles) x the group's head chunks, and per item TMA-loads q and do
// (64 rows = hpc heads x bq positions, 4-D boxes) into the ring, writing
// each row's position, query id, lse (log2 units), delta and (fused) dq
// row beside the stage.  Warpgroup w owns keys w*64..: S^T = k q^T, the
// mask per element in registers, p^T rounded to bf16 for dv += p^T do,
// dP^T = v do^T, ds^T = p^T (dP^T - delta) scale rounded to bf16 for dk +=
// ds^T q (do and q MN-major); the contraction over a tile's rows is the sum
// over the chunk's heads, so dk and dv stay in registers to the end, without
// atomics.  The fp32 p waits in shared memory while dP is computed (as
// hb_dkv_wgmma_kernel).  Fused: each consumer also stores its ds^T rows to
// shared memory (swizzled, as TMA would) and dq[64 rows] = ds K runs as an
// SS product with both operands MN-major: at d 128, after a barrier of both
// consumers, warpgroup w takes columns w*64.. over all 128 keys; at d 64
// each takes its own 64 keys.  The fp32 tile is added into the zeroed
// dq_acc by 16-byte vector reductions (red.global.add.v4.f32 through
// atomicAdd(float4)), lane pairs swapping halves so that each lane adds 4
// consecutive columns of one row.  Rows past hpc * bq are zeroed once in
// every stage (TMA never writes them) and, like rows past sq, read lse =
// +inf: their p and ds are exactly 0.  An empty list loads nothing and
// writes dk = dv = 0.
template <int D, bool kWithDq>
__global__ void __launch_bounds__(kWThreads, 1)
    masked_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, MArgs a, int groups) {
  using L = MaskedBwdSmem<D>;
  constexpr int S = kWithDq ? L::kFusedStages : kWStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];
  __shared__ __align__(8) float st_lse[S][kWBK];
  __shared__ __align__(8) float st_dlt[S][kWBK];
  __shared__ __align__(8) int st_pos[S][kWBK];
  __shared__ __align__(8) int st_qid[S][kWBK];
  __shared__ int st_row[S][kWBK];
  __shared__ int key_mask[5][kWRows];  // the CTA's key ids, lts, lte, uts, ute
  unsigned char* k_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* v_s = k_s + L::kPanels * L::kBig;
  unsigned char* ring = k_s + L::kResident;  // stage s: q, then do
  float* p_keep = reinterpret_cast<float*>(ring + S * L::kStage);
  unsigned char* ds_s = ring + S * L::kStage + L::kP;  // fused: two [128][64] ds^T tiles
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int g = static_cast<int>(blockIdx.x) % groups;
  const int ki = static_cast<int>(blockIdx.x) / groups;
  const int k0 = ki * kWRows;
  const size_t at = static_cast<size_t>(gate_row(a, g)) * a.n_outer + ki;
  const int chunks = a.rep / a.hpc;
  const int items = a.count[at] * chunks;  // (live q tile, head chunk) pairs
  const int rows = a.hpc * a.bq;           // real rows of a q tile, at most 64
  const int bi = g / a.kvh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  {
    const size_t bstride = static_cast<size_t>(a.batch) * a.mask_h * a.sk;
    const size_t brow = static_cast<size_t>(band_row(a, g)) * a.sk;
    for (int i = threadIdx.x; i < 5 * kWRows; i += kWThreads) {
      const int c = i / kWRows, kp = k0 + i % kWRows;
      int val = 0;
      if (kp < a.sk && c == 0 && a.k_seg != nullptr)
        val = a.k_seg[static_cast<size_t>(bi) * a.sk + kp];
      if (kp < a.sk && c > 0 && a.band != nullptr) val = a.band[(c - 1) * bstride + brow + kp];
      key_mask[c][i % kWRows] = val;
    }
  }
  if (rows < kWBK) {
    // rows [rows, 64) of every ringed panel: zero once, for the async proxy
    const int chunks16 = (kWBK - rows) * 8;  // 16-byte chunks of one panel
    const int panels = S * 2 * L::kPanels;
    for (int i = threadIdx.x; i < panels * chunks16; i += kWThreads)
      *reinterpret_cast<uint4*>(ring + (i / chunks16) * L::kSmall + rows * kPanel +
                                (i % chunks16) * 16) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kWProducerRegs>();
    if (warp > 8 || items == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kPanels * L::kBig);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_3d(k_s + p * L::kBig, &tk, kv_full, p * 64, k0, g);
        tma_load_3d(v_s + p * L::kBig, &tv, kv_full, p * 64, k0, g);
      }
    }
    const int* live = a.idx + at * a.n_inner;
    const float inf = __int_as_float(0x7f800000);
    for (int c = 0; c < items; ++c) {
      const int s = c % S, q0 = live[c / chunks] * a.bq, head0 = (c % chunks) * a.hpc;
      mbar_wait(&empty[s], ((c / S) & 1) ^ 1);
      for (int r = lane; r < kWBK; r += 32) {
        const int pos = q0 + r % a.bq;
        const bool ok = r < rows && pos < a.sq;
        const size_t row = (static_cast<size_t>(g) * a.rep + head0 + r / a.bq) * a.sq + pos;
        st_pos[s][r] = pos;
        st_lse[s][r] = ok ? a.lse[row] * kLog2e : inf;
        st_dlt[s][r] = ok ? a.delta[row] : 0.f;
        st_qid[s][r] = (ok && a.q_seg != nullptr) ? a.q_seg[static_cast<size_t>(bi) * a.sq + pos] : 0;
        st_row[s][r] = ok ? static_cast<int>(row) : -1;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::kPanels * kPanel * rows);
        unsigned char* dst = ring + s * L::kStage;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(dst + p * L::kSmall, &tq, &full[s], p * 64, q0, head0, g);
          tma_load_4d(dst + (L::kPanels + p) * L::kSmall, &tdo, &full[s], p * 64, q0, head0, g);
        }
      } else {
        mbar_arrive(&full[s]);  // the row data written above is released
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kWConsumerRegs>();
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  const int kl = wg * 64 + wq * 16 + lane / 4;  // this thread's keys: k0 + kl, k0 + kl + 8
  float* keep = p_keep + wg * 128 * 32 + threadIdx.x % 128;  // value i at keep[i * 128]
  const bool seg = a.q_seg != nullptr, bands = a.band != nullptr;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  if (items > 0) mbar_wait(kv_full, 0);
  for (int c = 0; c < items; ++c) {
    const int s = c % S;
    const unsigned char* q_t = ring + s * L::kStage;
    const unsigned char* do_t = q_t + L::kPanels * L::kSmall;
    mbar_wait(&full[s], (c / S) & 1);

    // S^T = k q^T over D in k steps of 16
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int p = ks / 4, j = ks % 4;
      wgmma_ss_n64<0, 0>(sc, smem_desc(k_s + p * L::kBig + wg * 64 * kPanel + j * 32, 16, 1024),
                         smem_desc(q_t + p * L::kSmall + j * 32, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // p^T with the mask per element (value i: key row j = (i / 2) % 2, q
    // row (i / 4) * 8 + (lane % 4) * 2 + i % 2), kept in fp32 for ds and
    // rounded to bf16 for dv += p^T do
    uint32_t af[16];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kp = k0 + kl + 8 * j;
      const int kid = key_mask[0][kl + 8 * j];
      const int lts = key_mask[1][kl + 8 * j], lte = key_mask[2][kl + 8 * j];
      const int uts = key_mask[3][kl + 8 * j], ute = key_mask[4][kl + 8 * j];
#pragma unroll
      for (int cg = 0; cg < 8; ++cg) {
        const int col = cg * 8 + (lane % 4) * 2;
        const int2 qp = *reinterpret_cast<const int2*>(&st_pos[s][col]);
        const int2 qid = *reinterpret_cast<const int2*>(&st_qid[s][col]);
        const float2 l2 = *reinterpret_cast<const float2*>(&st_lse[s][col]);
        float pv[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = cg * 4 + 2 * j + hi;
          const int q = hi ? qp.y : qp.x;
          bool on = kp < a.sk && (!a.causal || q >= kp);
          if (seg) on = on && (hi ? qid.y : qid.x) == kid;
          if (bands) on = on && !((q >= lts && q < lte) || (q >= uts && q < ute));
          const float p = on ? exp2f(sc[i] * sl2 - (hi ? l2.y : l2.x)) : 0.f;
          pv[hi] = p;
          keep[i * 128] = p;
        }
        af[cg * 2 + j] = pack_bf16(pv[0], pv[1]);
      }
    }

    // dv += p^T do, and dP^T = v do^T into sc
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWBK / 16; ++ks) {
      const uint32_t a4[4] = {af[4 * ks], af[4 * ks + 1], af[4 * ks + 2], af[4 * ks + 3]};
      wgmma_rs_mn<D>(dv, a4, smem_desc(do_t + ks * 16 * kPanel, L::kSmall, 1024));
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int p = ks / 4, j = ks % 4;
      wgmma_ss_n64<0, 0>(sc, smem_desc(v_s + p * L::kBig + wg * 64 * kPanel + j * 32, 16, 1024),
                         smem_desc(do_t + p * L::kSmall + j * 32, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dv);

    // ds^T = p^T (dP^T - delta) scale, rounded to bf16 for dk += ds^T q
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = (i / 4) * 8 + (lane % 4) * 2;
      const float2 d2 = *reinterpret_cast<const float2*>(&st_dlt[s][col]);
      af[i / 2] = pack_bf16(keep[i * 128] * (sc[i] - d2.x) * a.scale,
                            keep[(i + 1) * 128] * (sc[i + 1] - d2.y) * a.scale);
    }
    unsigned char* dsb = ds_s + (c & 1) * L::kDs;
    if constexpr (kWithDq) {
      // this thread's ds^T pairs into the [128 keys][64 rows] tile
#pragma unroll
      for (int cg = 0; cg < 8; ++cg)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<uint32_t*>(dsb + swizzle128(kl + 8 * j, cg * 16 + (lane % 4) * 4)) =
              af[cg * 2 + j];
      fence_proxy_async();
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWBK / 16; ++ks) {
      const uint32_t a4[4] = {af[4 * ks], af[4 * ks + 1], af[4 * ks + 2], af[4 * ks + 3]};
      wgmma_rs_mn<D>(dk, a4, smem_desc(q_t + ks * 16 * kPanel, L::kSmall, 1024));
    }
    wgmma_commit();
    if constexpr (kWithDq) {
      // dq[64 rows] = ds K: A = ds^T's rows (keys) as an MN-major operand,
      // B = K MN-major; d 128: all 128 keys, columns w*64..; d 64: own keys
      constexpr int kKeys = D == 128 ? kWRows : 64;
      const int key0 = D == 128 ? 0 : wg * 64;
      const unsigned char* kb = k_s + (D == 128 ? wg * L::kBig : 0);
      if (D == 128) named_barrier(1, 256);
      else named_barrier(1 + wg, 128);
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        const int r = (key0 + ks * 16) * kPanel;
        wgmma_ss_n64<1, 1>(sc, smem_desc(dsb + r, L::kDs, 1024), smem_desc(kb + r, L::kBig, 1024),
                           ks > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dk);
    if constexpr (kWithDq) {
      fence_regs(sc);
      // sc: dq rows wq*16 + lane/4 (+8), columns colbase + (i/4)*8 + (lane%4)*2
      // (+1); lane pairs swap so that the even lane adds row +0 and the odd
      // lane row +8, 4 columns each
      const int colbase = D == 128 ? wg * 64 : 0;
      const int odd = lane & 1;
      const int row = st_row[s][wq * 16 + lane / 4 + 8 * odd];
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? sc[i] : sc[i + 2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? sc[i + 1] : sc[i + 3], 1);
        const float4 v4 = odd ? make_float4(r0, r1, sc[i + 2], sc[i + 3])
                              : make_float4(sc[i], sc[i + 1], r0, r1);
        const int col = colbase + (i / 4) * 8 + (lane % 4) * 2 - 2 * odd;
        if (row >= 0) atomicAdd(reinterpret_cast<float4*>(a.dq_acc + static_cast<size_t>(row) * D + col), v4);
      }
    }
    mbar_arrive(&empty[s]);
  }

  const size_t koff = static_cast<size_t>(g) * a.sk * D;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + koff;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int kp = k0 + kl + 8 * ((i / 2) % 2);
    if (kp >= a.sk) continue;
    const size_t off = static_cast<size_t>(kp) * D + (i / 4) * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(dkg + off) = __floats2bfloat162_rn(dk[i], dk[i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dvg + off) = __floats2bfloat162_rn(dv[i], dv[i + 1]);
  }
}

// Kernel kinds of the C entry (ops/flash_attention.py MASKED_KINDS, then
// the wgmma kinds, _MASKED_WGMMA_KINDS).
enum Kind {
  kFwd = 0, kDq = 1, kDkv = 2, kFused = 3, kFwdWgmma = 4, kDqWgmma = 5, kDkvWgmma = 6,
  kFusedWgmma = 7
};

// Dynamic shared memory of each kernel: the layouts above, in bytes
// (ops/flash_attention.py masked_smem_bytes mirrors this to pick the tiles).
size_t smem_bytes(Kind kind, const MArgs& a, int d, size_t t) {
  const size_t m = static_cast<size_t>(a.hpc) * a.bq, bk = a.bk;
  const size_t ldd = d + kPad, ldk = bk + kPad;
  const size_t masks = 4 * (a.bq + 5 * bk);
  switch (kind) {
    case kFwd:
      return t * (m + 2 * bk) * ldd + 4 * m * ldk + t * m * ldk + 4 * m * ldd + 12 * m + masks;
    case kDq:
      return t * (2 * m + 2 * bk) * ldd + 8 * m * ldk + t * m * ldk + 4 * m * ldd + 8 * m + masks;
    default: {
      const size_t scores = kind == kFused ? (2 * m * ldk > m * ldd ? 2 * m * ldk : m * ldd)
                                           : 2 * m * ldk;
      return t * (2 * m + 2 * bk) * ldd + 4 * scores + 2 * t * m * ldk + 8 * bk * ldd + 8 * m +
             masks;
    }
  }
}

template <typename T, int D>
cudaError_t launch(Kind kind, const MArgs& a, int groups, cudaStream_t stream) {
  const size_t smem = smem_bytes(kind, a, D, sizeof(T));
  const int m = a.hpc * a.bq;
  if (smem > kSmemLimit || a.bq <= 0 || a.bk <= 0 || a.hpc <= 0 || a.rep % a.hpc != 0 ||
      a.mask_h <= 0 || a.kvh % a.mask_h != 0 || a.gate_h <= 0 || a.kvh % a.gate_h != 0)
    return cudaErrorInvalidValue;
  // tensor-core tiles: 16-row multiples for every product's operands
  if (sizeof(T) == 2 && (m % 16 != 0 || a.bk % 16 != 0)) return cudaErrorInvalidValue;
  // bf16 at d 64 and 128 runs the wgmma kernels (launch_fwd_wgmma,
  // launch_bwd_wgmma): no shared-memory instantiation of those
  void (*kernel)(MArgs) = nullptr;
  if constexpr (sizeof(T) == 2 && D >= 64) {
    return cudaErrorInvalidValue;
  } else {
    kernel = kind == kFwd   ? masked_fwd_kernel<T, D>
             : kind == kDq  ? masked_dq_kernel<T, D>
             : kind == kDkv ? masked_dkv_kernel<T, D, false>
                            : masked_dkv_kernel<T, D, true>;
  }
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const bool per_k = kind == kDkv || kind == kFused;
  const dim3 grid(per_k ? (a.sk + a.bk - 1) / a.bk : (a.sq + a.bq - 1) / a.bq,
                  per_k ? groups : groups * (a.rep / a.hpc));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || kind != kFused || sizeof(T) == 4) return e;
  // bf16: the fp32 dq sums to q's dtype
  const size_t n = static_cast<size_t>(groups) * a.rep * a.sq * D;
  const int blocks = static_cast<int>(n / kThreads / 8 + 1 < 4096 ? n / kThreads / 8 + 1 : 4096);
  cast_kernel<T><<<blocks, kThreads, 0, stream>>>(a.dq_acc, static_cast<T*>(a.dq), n);
  return cudaGetLastError();
}

// B5 on wgmma: bf16, d 64 or 128, a.bk == kWBK, hpc * bq <= 128 rows.  The
// tensor maps: q as (d, sq, rep, groups) with the box (64, bq, hpc, 1), k
// and v as (d, sk, groups); one CTA per (q tile, group, head chunk).
template <int D>
cudaError_t launch_fwd_wgmma(const MArgs& a, int groups, cudaStream_t stream) {
  using L = MaskedWgmmaSmem<D>;
  if (a.bk != kWBK || a.bq <= 0 || a.hpc <= 0 || a.hpc > 8 || a.rep % a.hpc != 0 ||
      a.hpc * a.bq > kWRows || a.n_outer != (a.sq + a.bq - 1) / a.bq || a.mask_h <= 0 ||
      a.kvh % a.mask_h != 0 || a.gate_h <= 0 || a.kvh % a.gate_h != 0)
    return cudaErrorInvalidValue;
  const uint64_t row = D * 2;
  const uint64_t qd[4] = {D, static_cast<uint64_t>(a.sq), static_cast<uint64_t>(a.rep),
                          static_cast<uint64_t>(groups)};
  const uint64_t qs[3] = {row, row * a.sq, row * a.sq * a.rep};
  const uint32_t qb[4] = {64, static_cast<uint32_t>(a.bq), static_cast<uint32_t>(a.hpc), 1};
  const uint64_t kd[3] = {D, static_cast<uint64_t>(a.sk), static_cast<uint64_t>(groups)};
  const uint64_t ks[2] = {row, row * a.sk};
  const uint32_t kb[3] = {64, kWBK, 1};
  CUtensorMap tq, tk, tv;
  cudaError_t e = encode_bf16_map(&tq, a.q, 4, qd, qs, qb);
  if (e == cudaSuccess) e = encode_bf16_map(&tk, a.k, 3, kd, ks, kb);
  if (e == cudaSuccess) e = encode_bf16_map(&tv, a.v, 3, kd, ks, kb);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(masked_fwd_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return e;
  const int ctas = a.n_outer * groups * (a.rep / a.hpc);
  masked_fwd_wgmma_kernel<D><<<ctas, kWThreads, L::kBytes, stream>>>(tq, tk, tv, a, groups);
  return cudaGetLastError();
}

// B6 on wgmma: bf16, d 64 or 128.  kDqWgmma: a.bk == kWBK keys per ringed
// k tile, hpc * bq <= 128 rows per CTA, one CTA per (q tile, group, head
// chunk); kDkvWgmma and kFusedWgmma: a.bk == kWRows keys per CTA, hpc * bq
// <= 64 rows per ringed q tile, one CTA per (k tile, group), the fused kind
// followed by the cast of dq_acc into dq.  The tensor maps: q and do as (d,
// sq, rep, groups) with the box (64, bq, hpc, 1), k and v as (d, sk,
// groups) with the box (64, bk, 1).
template <int D>
cudaError_t launch_bwd_wgmma(Kind kind, const MArgs& a, int groups, cudaStream_t stream) {
  using L = MaskedBwdSmem<D>;
  const bool dq = kind == kDqWgmma, fused = kind == kFusedWgmma;
  const int rows = dq ? kWRows : kWBK;
  const int outer = dq ? (a.sq + a.bq - 1) / a.bq : (a.sk + a.bk - 1) / a.bk;
  if (a.bk != (dq ? kWBK : kWRows) || a.bq <= 0 || a.hpc <= 0 || a.hpc > 8 ||
      a.rep % a.hpc != 0 || a.hpc * a.bq > rows || a.n_outer != outer || a.mask_h <= 0 ||
      a.kvh % a.mask_h != 0 || a.gate_h <= 0 || a.kvh % a.gate_h != 0 ||
      (fused && a.dq_acc == nullptr))
    return cudaErrorInvalidValue;
  const uint64_t row = D * 2;
  const uint64_t qd[4] = {D, static_cast<uint64_t>(a.sq), static_cast<uint64_t>(a.rep),
                          static_cast<uint64_t>(groups)};
  const uint64_t qs[3] = {row, row * a.sq, row * a.sq * a.rep};
  const uint32_t qb[4] = {64, static_cast<uint32_t>(a.bq), static_cast<uint32_t>(a.hpc), 1};
  const uint64_t kd[3] = {D, static_cast<uint64_t>(a.sk), static_cast<uint64_t>(groups)};
  const uint64_t ks[2] = {row, row * a.sk};
  const uint32_t kb[3] = {64, static_cast<uint32_t>(a.bk), 1};
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t e = encode_bf16_map(&tq, a.q, 4, qd, qs, qb);
  if (e == cudaSuccess) e = encode_bf16_map(&tdo, a.dout, 4, qd, qs, qb);
  if (e == cudaSuccess) e = encode_bf16_map(&tk, a.k, 3, kd, ks, kb);
  if (e == cudaSuccess) e = encode_bf16_map(&tv, a.v, 3, kd, ks, kb);
  if (e != cudaSuccess) return e;
  if (dq) {
    e = cudaFuncSetAttribute(masked_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqBytes);
    if (e != cudaSuccess) return e;
    const int ctas = a.n_outer * groups * (a.rep / a.hpc);
    masked_dq_wgmma_kernel<D><<<ctas, kWThreads, L::kDqBytes, stream>>>(tq, tdo, tk, tv, a,
                                                                         groups);
    return cudaGetLastError();
  }
  auto kernel = fused ? masked_dkv_wgmma_kernel<D, true> : masked_dkv_wgmma_kernel<D, false>;
  const int bytes = L::dkv_bytes(fused);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<a.n_outer * groups, kWThreads, bytes, stream>>>(tq, tdo, tk, tv, a, groups);
  e = cudaGetLastError();
  if (e != cudaSuccess || !fused) return e;
  const size_t n = static_cast<size_t>(groups) * a.rep * a.sq * D;
  const int blocks = static_cast<int>(n / kThreads / 8 + 1 < 4096 ? n / kThreads / 8 + 1 : 4096);
  cast_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
      a.dq_acc, static_cast<__nv_bfloat16*>(a.dq), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Kind kind, const MArgs& a, int groups, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(kind, a, groups, s);
    case 32: return launch<T, 32>(kind, a, groups, s);
    case 64: return launch<T, 64>(kind, a, groups, s);
    case 128: return launch<T, 128>(kind, a, groups, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One entry for every kernel: kind (Kind), 17 pointers and 14 ints in
// the order of ops/flash_attention.py _masked_launch:
//   ptrs: q, k, v, do, lse, delta, o, lse_out, dq, dq_acc, dk, dv, q_seg,
//         k_seg, band, count, idx (null where a kind does not use one)
//   ints: batch, kvh, rep, hpc, sq, sk, d, bq, bk, mask_h, gate_h, n_outer,
//         n_inner, causal
// The fused kind runs its pass, then (bf16) the cast of dq_acc into dq; for
// fp32, dq_acc is dq itself.  kFwdWgmma runs masked_fwd_wgmma_kernel (bf16,
// d 64 or 128: the wrapper's masked_fwd_route), kFwd masked_fwd_kernel;
// kDqWgmma, kDkvWgmma and kFusedWgmma the B6 wgmma kernels (bf16, d 64 or
// 128: masked_bwd_route), the fused kind with its cast.
int pt_masked_flash(int kind, void* const* p, const int* n, float scale, int dtype,
                    void* stream) {
  if (kind < kFwd || kind > kFusedWgmma) return cudaErrorInvalidValue;
  MArgs a{};
  a.q = p[0];
  a.k = p[1];
  a.v = p[2];
  a.dout = p[3];
  a.lse = static_cast<const float*>(p[4]);
  a.delta = static_cast<const float*>(p[5]);
  a.o = p[6];
  a.lse_out = static_cast<float*>(p[7]);
  a.dq = p[8];
  a.dq_acc = static_cast<float*>(p[9]);
  a.dk = p[10];
  a.dv = p[11];
  a.q_seg = static_cast<const int*>(p[12]);
  a.k_seg = static_cast<const int*>(p[13]);
  a.band = static_cast<const int*>(p[14]);
  a.count = static_cast<const int*>(p[15]);
  a.idx = static_cast<const int*>(p[16]);
  a.batch = n[0];
  a.kvh = n[1];
  a.rep = n[2];
  a.hpc = n[3];
  a.sq = n[4];
  a.sk = n[5];
  const int d = n[6];
  a.bq = n[7];
  a.bk = n[8];
  a.mask_h = n[9];
  a.gate_h = n[10];
  a.n_outer = n[11];
  a.n_inner = n[12];
  a.causal = n[13];
  a.scale = scale;
  const int groups = a.batch * a.kvh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Kind k = static_cast<Kind>(kind);
  if (k == kFwdWgmma) {
    if (dtype != kBF16) return cudaErrorInvalidValue;
    if (d == 64) return launch_fwd_wgmma<64>(a, groups, s);
    if (d == 128) return launch_fwd_wgmma<128>(a, groups, s);
    return cudaErrorInvalidValue;
  }
  if (k >= kDqWgmma) {
    if (dtype != kBF16) return cudaErrorInvalidValue;
    if (d == 64) return launch_bwd_wgmma<64>(k, a, groups, s);
    if (d == 128) return launch_bwd_wgmma<128>(k, a, groups, s);
    return cudaErrorInvalidValue;
  }
  if (dtype == kF32) return dispatch_d<float>(k, a, groups, d, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(k, a, groups, d, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
