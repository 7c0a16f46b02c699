// Head-batched flash attention for Hopper (sm_90a): the training forward and
// backward of GQA self-attention, with a plain C interface loaded through
// ctypes (paddle_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Replaces the two Pallas TPU kernel bodies of the head-batched path of
// paddle_tpu/ops/pallas/flash_attention.py:
//   - _hb_flash_kernel (launcher _hb_flash_forward, B1) -> pt_hb_flash_forward
//       hb_fwd_wgmma_kernel for bf16 at head dim 64 and 128, hb_fwd_kernel
//       for bf16 at 16 and 32 and for fp32 (the wrapper's fwd_route);
//   - _hb_bwd_kernel (launcher _hb_flash_backward, B2)  -> pt_hb_flash_backward
//       two kernels, dk/dv then dq: hb_dkv_wgmma_kernel and
//       hb_dq_wgmma_kernel for bf16 at head dim 64 and 128, hb_dkv_kernel
//       and hb_dq_kernel for bf16 at 16 and 32 and for fp32 (bwd_route).
//
// Layouts (as the TPU launchers'): q, o, do, dq [groups, rep, sq, d]; k, v, dk,
// dv [groups, sk, d]; lse, delta [groups, rep, sq] fp32 (the TPU's 8-row lse
// broadcast is sublane padding and is dropped).  A group is one (batch, kv
// head); its rep q heads share the group's K/V.
//
// What bounds it on the H100: operations.  At the training shape (b 6, s 1024,
// 16 q heads over 4 kv heads, d 128, causal) the forward does 4*b*h*s^2*d/2 =
// 25.8 GFLOP on 63 MB of q, k, v and o: 0.026 ms at 989 TFLOP/s against
// 0.019 ms of bytes at 3.35 TB/s; the backward 2.5x the operations.  So the
// products have to run on the tensor cores and K/V should cross device memory
// as few times as possible.  The design:
//   - one CTA covers rep * block_q query rows: all rep heads of a group at the
//     same positions.  Each K/V tile is staged in shared memory once and used
//     by every head of the group, which is B1's point (rep x fewer K/V reads
//     than a per-head kernel); the same holds for the backward's Q/dO tiles;
//   - the k loop runs inside the CTA (the TPU walks k tiles over its
//     sequential grid axis) with the fp32 online-softmax state and the fp32
//     output accumulator in shared memory, and stops at the causal limit, so
//     fully masked tiles cost nothing (the TPU's pl.when skip);
//   - B1 bf16 at d 64/128 (hb_fwd_wgmma_kernel, on the Hopper blocks of
//     hopper.cuh) keeps the scores, the softmax state and the output
//     accumulator out of shared memory and its loads off the threads: one
//     producer warp keeps K/V tiles (64 keys) in flight by TMA in a
//     3-stage mbarrier ring; two consumer warpgroups own 64 of the CTA's
//     128 rows each, run S = Q K^T on wgmma (K-major operands from shared
//     memory), keep S, m, l and O in registers, and feed p as bf16
//     registers to O += P V (V an MN-major operand, not transposed in
//     memory).  Only tiles that cross the diagonal or sk are masked; q
//     tiles run longest first;
//   - the backward splits B2's fused pass in two, both deterministic (no
//     atomics): dk/dv runs one CTA per (group, k tile), loops over q tiles
//     and keeps dK/dV of the whole group, so the sum over the rep heads is
//     the contraction over a q tile's rows; dq runs one CTA per (group, q
//     tile) and loops over k tiles.  The TPU's one sequential grid carries
//     dq and dk/dv in scratch; here the dq kernel recomputes S and dP
//     instead (7 products per tile pair instead of 5).  Both recompute p
//     from (q, k, lse); delta = rowsum(do * o) comes from the caller, as the
//     TPU launcher computes it outside its kernel;
//   - B2 bf16 at d 64/128 (hb_dkv_wgmma_kernel, hb_dq_wgmma_kernel) is B1's
//     structure with the backward's products: a producer warp's TMA ring,
//     two consumer warpgroups of 64 rows (dq) or 64 keys (dk/dv) each, S and
//     dP on wgmma from K-major operands, p and ds in registers, rounded to
//     bf16 as the register A operand of dq += ds k, dv += p^T do and dk +=
//     ds^T q (k, do, q MN-major, not transposed in memory), dq or dk/dv in
//     registers to the end.  At d 128 the dk/dv kernel would hold two 64 x
//     128 accumulators and two 64 x 64 score tiles; it parks the fp32 p in
//     shared memory while dP is computed instead;
//   - other bf16 products (d 16, 32) run on the tensor cores (nvcuda::wmma,
//     16x16x16, fp32 accumulation from shared memory); fp32 inputs take a
//     CUDA-core path with the same data flow (the CPU-comparable case).
// Left for later work: no kernel overlaps its softmax or ds with its
// warpgroup's products (two warpgroups in ping-pong, or two tiles in
// flight); the dk/dv kernel's causal loops are uneven across CTAs (a
// persistent grid would balance them).
//
// Semantics kept from the TPU kernels (tests/test_torch_flash_attention.py):
//   - masking with NEG_INF = -1e30, never -inf; causal keeps k_pos <= q_pos;
//     key positions past sk are masked and their V rows read as 0;
//   - fp32 scores and softmax state; scale multiplies the fp32 dot;
//   - forward: p rounded to v's dtype before the PV product; l sums the
//     unrounded p; lse = m + log l, or +1e30 and o = 0 for a row that sees
//     no key;
//   - backward: p = exp(s - lse); ds = p * (dp - delta) * scale; ds rounded to
//     k's dtype for dq, p to do's dtype for dv, ds to q's dtype for dk; query
//     rows past sq contribute nothing.

#include "flash_common.cuh"  // Mma, dtype helpers, warp reductions, kThreads
#include "hopper.cuh"        // TMA, mbarriers, wgmma

namespace {

struct Args {
  const void* q;      // [groups, rep, sq, d]
  const void* k;      // [groups, sk, d]
  const void* v;
  const void* dout;   // backward: do, q-shaped
  const float* lse;   // backward input / forward output, [groups, rep, sq]
  const float* delta; // backward: rowsum(do * o), [groups, rep, sq]
  void* o;            // forward output, q-shaped
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int rep, sq, sk;
  int bq, bk;         // query positions and keys per tile; a CTA covers rep * bq rows
  int causal;
  float scale;
};

// Rows [0, rep*bq) of a q-shaped tile: row m is head m / bq at position
// q0 + m % bq of the group at `base`; rows past sq are zero.  16-byte copies.
template <typename T, int D>
__device__ void load_q_rows(T* dst, const T* base, const Args& a, int q0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = D / V;
  const int M = a.rep * a.bq;
  for (int idx = threadIdx.x; idx < M * C; idx += kThreads) {
    const int m = idx / C, c = idx % C;
    const int pos = q0 + m % a.bq;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < a.sq)
      val = *reinterpret_cast<const uint4*>(
          base + (static_cast<size_t>(m / a.bq) * a.sq + pos) * D + c * V);
    *reinterpret_cast<uint4*>(dst + m * (D + kPad) + c * V) = val;
  }
}

// Rows [0, bk) of a k-shaped tile starting at key k0; rows past sk are zero.
template <typename T, int D>
__device__ void load_k_rows(T* dst, const T* base, const Args& a, int k0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = D / V;
  for (int idx = threadIdx.x; idx < a.bk * C; idx += kThreads) {
    const int j = idx / C, c = idx % C;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k0 + j < a.sk)
      val = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(k0 + j) * D + c * V);
    *reinterpret_cast<uint4*>(dst + j * (D + kPad) + c * V) = val;
  }
}

// The causal mask of one score, and the padding-key mask.
__device__ __forceinline__ bool keep(const Args& a, int q_pos, int k_pos) {
  return k_pos < a.sk && (!a.causal || q_pos >= k_pos);
}

// Number of k tiles a q tile at q0 visits: all of them, or up to the causal
// limit (the TPU kernel's pl.when((qi + 1) * block_q - 1 >= ki * block_k)).
__device__ __forceinline__ int k_tiles(const Args& a, int q0) {
  int nk = (a.sk + a.bk - 1) / a.bk;
  if (a.causal) {
    const int last = min(q0 + a.bq, a.sq) - 1;  // last real query position
    nk = min(nk, last / a.bk + 1);
  }
  return nk;
}

// ---------------------------------------------------------------- B1 forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) hb_fwd_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.rep * a.bq;
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

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * a.bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qg = static_cast<const T*>(a.q) + static_cast<size_t>(g) * a.rep * a.sq * D;
  const T* kg = static_cast<const T*>(a.k) + static_cast<size_t>(g) * a.sk * D;
  const T* vg = static_cast<const T*>(a.v) + static_cast<size_t>(g) * a.sk * D;

  load_q_rows<T, D>(q_s, qg, a, q0);
  for (int i = tid; i < M * ldd; i += kThreads) o_s[i] = 0.f;
  for (int m = tid; m < M; m += kThreads) {
    m_s[m] = kNegInf;
    l_s[m] = 0.f;
  }

  const int nk = k_tiles(a, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * a.bk;
    __syncthreads();  // the previous tile's readers of k_s, v_s, p_s are done
    load_k_rows<T, D>(k_s, kg, a, k0);
    load_k_rows<T, D>(v_s, vg, a, k0);
    __syncthreads();
    Mma<T>::abt(s_s, ldk, q_s, ldd, k_s, ldd, M, a.bk, D);
    __syncthreads();

    // online softmax: one warp per row, lanes over the tile's keys
    for (int m = warp; m < M; m += kWarps) {
      const int q_pos = q0 + m % a.bq;
      float* srow = s_s + m * ldk;
      float mx = kNegInf;
      for (int j = lane; j < a.bk; j += 32) {
        const float s = keep(a, q_pos, k0 + j) ? srow[j] * a.scale : kNegInf;
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

  T* og = static_cast<T*>(a.o) + static_cast<size_t>(g) * a.rep * a.sq * D;
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
    a.lse_out[(static_cast<size_t>(g) * a.rep + m / a.bq) * a.sq + pos] =
        valid ? m_s[m] + logf(l) : -kNegInf;
  }
}

// ------------------------------------------------- B1 forward, bf16 on wgmma
constexpr int kFwdRows = 128;    // rows of a CTA: two consumer warpgroups of 64
constexpr int kFwdBK = 64;       // keys per k tile
constexpr int kFwdStages = 3;    // K/V ring depth
constexpr int kFwdThreads = 288; // two consumer warpgroups, then one producer warp
constexpr int kPanel = 128;      // bytes of one row of a 64-column panel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of hb_fwd_wgmma_kernel: q [D/64 panels][128 rows][64], then
// per stage k and v [D/64 panels][kFwdBK rows][64]; 1024 bytes of slack
// align the tiles to the swizzle atom.
template <int D>
struct FwdWgmmaSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kQPanel = kFwdRows * kPanel;
  static constexpr int kKVPanel = kFwdBK * kPanel;
  static constexpr int kTile = kPanels * kKVPanel;  // one k or v tile
  static constexpr int kBytes = kPanels * kQPanel + 2 * kFwdStages * kTile + 1024;
};

// One CTA per (group, q tile of bq positions x rep heads = at most 128
// rows), q tiles longest first.  Warp 8 is the producer: one TMA load of
// the q tile (a 4-D box (64, bq, rep, 1) per panel, zero past sq), then
// the k tiles' K and V through a kFwdStages ring of mbarriers.  Warpgroups
// 0 and 1 each own 64 rows: S = Q K^T (wgmma, both operands K-major from
// shared memory, S in registers), the online softmax in registers (a row's
// 16 values per thread, reduced over the 4 threads that share the row), p
// rounded to bf16 in registers as the A operand of O += P V (V MN-major
// from shared memory, not transposed in memory), O rescaled in registers.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    hb_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Args a, int groups) {
  using L = FwdWgmmaSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kFwdStages];
  unsigned char* q_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* kv_s = q_s + L::kPanels * L::kQPanel;  // stage s: k, then v
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kFwdStages;

  const int nq = (a.sq + a.bq - 1) / a.bq;
  const int g = blockIdx.x % groups;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / groups) * a.bq;
  const int nk = k_tiles(a, q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, L::kPanels * kPanel * a.bq * a.rep);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_4d(q_s + p * L::kQPanel, &tq, q_full, p * 64, q0, 0, g);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kFwdStages;
        mbar_wait(&empty[s], ((kt / kFwdStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        unsigned char* k_dst = kv_s + s * 2 * L::kTile;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(k_dst + p * L::kKVPanel, &tk, &full[s], p * 64, kt * kFwdBK, g);
          tma_load_3d(k_dst + L::kTile + p * L::kKVPanel, &tv, &full[s], p * 64, kt * kFwdBK, g);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  // this thread's two rows of the accumulator layout (j = 0, 1: +8 rows)
  int head[2], pos[2];
  bool row_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = wg * 64 + wq * 16 + lane / 4 + 8 * j;
    head[j] = m / a.bq;
    pos[j] = q0 + m % a.bq;
    row_ok[j] = m < a.rep * a.bq && pos[j] < a.sq;  // rows past rep * bq are never loaded
  }
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

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kFwdStages;
    const int k0 = kt * kFwdBK;
    const unsigned char* k_s = kv_s + s * 2 * L::kTile;
    const unsigned char* v_s = k_s + L::kTile;
    mbar_wait(&full[s], (kt / kFwdStages) & 1);

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

    // masking: only tiles past the first row's position or past sk
    const bool edge = (a.causal && k0 + kFwdBK - 1 > q0) || k0 + kFwdBK > a.sk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i / 2) % 2;
      float v = sc[i] * sl2;
      if (edge) {
        const int kp = k0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
        if (kp >= a.sk || (a.causal && kp > pos[j])) v = kNegInf;
      }
      sc[i] = v;
      mx[j] = fmaxf(mx[j], v);
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
    for (int ks = 0; ks < kFwdBK / 16; ++ks) {
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

// ------------------------------------------------ B2 backward, bf16 on wgmma
constexpr int kBwdRows = 128;     // dq: q rows of a CTA; dk/dv: keys of a CTA
constexpr int kBwdTile = 64;      // dq: keys per k tile; dk/dv: q rows per q tile
constexpr int kBwdStages = 3;     // ring depth
// two consumer warpgroups, then a producer warpgroup of which warp 8 loads:
// the producer gives its registers back (setmaxnreg) so that each consumer
// thread can hold up to kBwdConsumerRegs (the cap of a 288-thread CTA is 168)
constexpr int kBwdThreads = 384;
constexpr int kBwdProducerRegs = 40, kBwdConsumerRegs = 232;

// Shared memory of the two backward kernels: the CTA's resident pair
// [D/64 panels][128 rows][64] (dq: q and do; dk/dv: k and v), then per stage
// the ringed pair [D/64 panels][64 rows][64] (dq: k and v; dk/dv: q and do);
// dk/dv adds each consumer thread's fp32 p of the current q tile (32
// values, 32 KB for the CTA).  1024 bytes of slack align the tiles.
template <int D>
struct BwdWgmmaSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kBig = kBwdRows * kPanel;      // one panel of a resident tile
  static constexpr int kSmall = kBwdTile * kPanel;    // one panel of a ringed tile
  static constexpr int kResident = 2 * kPanels * kBig;
  static constexpr int kStage = 2 * kPanels * kSmall;
  static constexpr int kP = 2 * 128 * 32 * 4;         // dk/dv only
  static constexpr int kDqBytes = kResident + kBwdStages * kStage + 1024;
  static constexpr int kDkvBytes = kResident + kBwdStages * kStage + kP + 1024;
};

// dq per q tile.  One CTA per (group, q tile of bq positions x rep heads =
// at most 128 rows), q tiles longest first.  Warp 8 is the producer: one
// TMA load of the q and do tiles (4-D boxes (64, bq, rep, 1) per panel,
// zero past sq), then the k tiles' K and V (64 keys) through a kBwdStages
// ring.  Warpgroup w owns rows w*64..: per k tile S = q k^T and dP = do v^T
// (wgmma, K-major operands from shared memory), p = exp(s * scale - lse)
// and ds = p (dP - delta) scale in registers, ds rounded to bf16 as the
// register A operand of dq += ds k (k MN-major, not transposed in memory).
// dq stays in registers to the end; causal: the k loop stops at the q
// tile's last position.  Rows past rep * bq (idle when rep does not divide
// 128) and past sq get p = ds = 0 and are never stored.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    hb_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, Args a, int groups) {
  using L = BwdWgmmaSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kBwdStages];
  unsigned char* q_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* do_s = q_s + L::kPanels * L::kBig;
  unsigned char* kv_s = q_s + L::kResident;  // stage s: k, then v
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kBwdStages;

  const int nq = (a.sq + a.bq - 1) / a.bq;
  const int g = blockIdx.x % groups;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / groups) * a.bq;
  const int nk = k_tiles(a, q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kBwdProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::kPanels * kPanel * a.bq * a.rep);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_4d(q_s + p * L::kBig, &tq, q_full, p * 64, q0, 0, g);
        tma_load_4d(do_s + p * L::kBig, &tdo, q_full, p * 64, q0, 0, g);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kBwdStages;
        mbar_wait(&empty[s], ((kt / kBwdStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], L::kStage);
        unsigned char* k_dst = kv_s + s * L::kStage;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(k_dst + p * L::kSmall, &tk, &full[s], p * 64, kt * kBwdTile, g);
          tma_load_3d(k_dst + (L::kPanels + p) * L::kSmall, &tv, &full[s], p * 64,
                      kt * kBwdTile, g);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kBwdConsumerRegs>();
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  // this thread's two rows of the accumulator layout (j = 0, 1: +8 rows),
  // with lse in log2 units and delta; rows that are not real read p = 0
  int head[2], pos[2];
  bool row_ok[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = wg * 64 + wq * 16 + lane / 4 + 8 * j;
    head[j] = m / a.bq;
    pos[j] = q0 + m % a.bq;
    row_ok[j] = m < a.rep * a.bq && pos[j] < a.sq;
    const size_t at = (static_cast<size_t>(g) * a.rep + head[j]) * a.sq + pos[j];
    lse2[j] = row_ok[j] ? a.lse[at] * kLog2e : 0.f;
    dlt[j] = row_ok[j] ? a.delta[at] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kBwdStages;
    const int k0 = kt * kBwdTile;
    const unsigned char* k_s = kv_s + s * L::kStage;
    const unsigned char* v_s = k_s + L::kPanels * L::kSmall;
    mbar_wait(&full[s], (kt / kBwdStages) & 1);

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

    // ds = p (dP - delta) scale, rounded to bf16: the A operand of dq += ds k
    const bool edge = (a.causal && k0 + kBwdTile - 1 > q0) || k0 + kBwdTile > a.sk;
    uint32_t af[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int j = (i / 2) % 2;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + (i / 4) * 8 + (lane % 4) * 2 + e;
        float p = exp2f(sc[i + e] * sl2 - lse2[j]);
        if (edge && (kp >= a.sk || (a.causal && kp > pos[j]))) p = 0.f;
        ds[e] = row_ok[j] ? p * (dp[i + e] - dlt[j]) * a.scale : 0.f;
      }
      af[i / 2] = pack_bf16(ds[0], ds[1]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBwdTile / 16; ++ks) {
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

// dk and dv per k tile.  One CTA per (group, 128 keys), k tiles from the
// first key (the longest causal loops first), K and V staged once.  Warp 8
// is the producer: the K and V tiles (3-D boxes (64, 128, 1)), then the q
// tiles' q and do (64 rows = bq positions x rep heads, 4-D boxes) through a
// kBwdStages ring, with each tile row's position, lse (log2 units) and
// delta written to shared memory beside them.  Warpgroup w owns keys
// w*64..: per q tile S^T = k q^T and dP^T = v do^T (wgmma, K-major operands
// from shared memory), p^T = exp(s * scale - lse) rounded to bf16 as the
// register A operand of dv += p^T do, then ds^T = p^T (dP^T - delta) scale
// rounded to bf16 for dk += ds^T q (do and q MN-major).  The contraction
// over a tile's rows is the sum over the group's heads.  dk and dv stay in
// registers to the end; the fp32 p waits in shared memory (each thread's
// own 32 values) while dP is computed, so two 64 x d accumulators and one
// 64 x 64 tile are live at a time.  Causal: the first q tile is the first
// that reaches the CTA's first key.  Rows past rep * bq are zeroed once in
// every stage (TMA never writes them) and, like rows past sq, read lse =
// +inf: their p and ds are exactly 0.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    hb_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Args a, int groups) {
  using L = BwdWgmmaSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kBwdStages];
  __shared__ float st_lse[kBwdStages][kBwdTile], st_dlt[kBwdStages][kBwdTile];
  __shared__ int st_pos[kBwdStages][kBwdTile];
  unsigned char* k_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* v_s = k_s + L::kPanels * L::kBig;
  unsigned char* ring = k_s + L::kResident;  // stage s: q, then do
  float* p_keep = reinterpret_cast<float*>(ring + kBwdStages * L::kStage);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kBwdStages;

  const int g = blockIdx.x % groups;
  const int k0 = static_cast<int>(blockIdx.x) / groups * kBwdRows;
  const int rows = a.rep * a.bq;  // real rows of a q tile, at most 64
  const int nq = (a.sq + a.bq - 1) / a.bq;
  const int qt0 = a.causal ? min(k0 / a.bq, nq) : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  if (rows < kBwdTile) {
    // rows [rows, 64) of every ringed panel: zero once, for the async proxy
    const int chunks = (kBwdTile - rows) * 8;  // 16-byte chunks of one panel
    const int panels = kBwdStages * 2 * L::kPanels;
    for (int i = threadIdx.x; i < panels * chunks; i += kBwdThreads)
      *reinterpret_cast<uint4*>(ring + (i / chunks) * L::kSmall + rows * kPanel +
                                (i % chunks) * 16) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kBwdProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kPanels * L::kBig);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_3d(k_s + p * L::kBig, &tk, kv_full, p * 64, k0, g);
        tma_load_3d(v_s + p * L::kBig, &tv, kv_full, p * 64, k0, g);
      }
    }
    for (int c = 0; c < nq - qt0; ++c) {
      const int s = c % kBwdStages, q0 = (qt0 + c) * a.bq;
      mbar_wait(&empty[s], ((c / kBwdStages) & 1) ^ 1);
      for (int r = lane; r < kBwdTile; r += 32) {
        const int pos = q0 + r % a.bq;
        const bool ok = r < rows && pos < a.sq;
        const size_t at = (static_cast<size_t>(g) * a.rep + r / a.bq) * a.sq + pos;
        st_pos[s][r] = pos;
        st_lse[s][r] = ok ? a.lse[at] * kLog2e : __int_as_float(0x7f800000);
        st_dlt[s][r] = ok ? a.delta[at] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::kPanels * kPanel * rows);
        unsigned char* dst = ring + s * L::kStage;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(dst + p * L::kSmall, &tq, &full[s], p * 64, q0, 0, g);
          tma_load_4d(dst + (L::kPanels + p) * L::kSmall, &tdo, &full[s], p * 64, q0, 0, g);
        }
      } else {
        mbar_arrive(&full[s]);  // the row statistics written above are released
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kBwdConsumerRegs>();
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  const int key = k0 + wg * 64 + wq * 16 + lane / 4;  // this thread's keys: key, key + 8
  float* keep = p_keep + wg * 128 * 32 + threadIdx.x % 128;  // value i at keep[i * 128]
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  mbar_wait(kv_full, 0);
  for (int c = 0; c < nq - qt0; ++c) {
    const int s = c % kBwdStages, q0 = (qt0 + c) * a.bq;
    const unsigned char* q_t = ring + s * L::kStage;
    const unsigned char* do_t = q_t + L::kPanels * L::kSmall;
    mbar_wait(&full[s], (c / kBwdStages) & 1);

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

    // p^T, kept in fp32 for ds and rounded to bf16 for dv += p^T do
    const bool edge = (a.causal && q0 < k0 + kBwdRows - 1) || k0 + kBwdRows > a.sk;
    uint32_t af[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int kp = key + 8 * ((i / 2) % 2);
      float pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = (i / 4) * 8 + (lane % 4) * 2 + e;
        float p = exp2f(sc[i + e] * sl2 - st_lse[s][col]);
        if (edge && (kp >= a.sk || (a.causal && kp > st_pos[s][col]))) p = 0.f;
        pv[e] = p;
        keep[(i + e) * 128] = p;
      }
      af[i / 2] = pack_bf16(pv[0], pv[1]);
    }

    // dv += p^T do, and dP^T = v do^T into sc
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBwdTile / 16; ++ks) {
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
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = (i / 4) * 8 + (lane % 4) * 2 + e;
        ds[e] = keep[(i + e) * 128] * (sc[i + e] - st_dlt[s][col]) * a.scale;
      }
      af[i / 2] = pack_bf16(ds[0], ds[1]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBwdTile / 16; ++ks) {
      const uint32_t a4[4] = {af[4 * ks], af[4 * ks + 1], af[4 * ks + 2], af[4 * ks + 3]};
      wgmma_rs_mn<D>(dk, a4, smem_desc(q_t + ks * 16 * kPanel, L::kSmall, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    mbar_arrive(&empty[s]);
  }

  const size_t koff = static_cast<size_t>(g) * a.sk * D;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + koff;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int kp = key + 8 * ((i / 2) % 2);
    if (kp >= a.sk) continue;
    const size_t at = static_cast<size_t>(kp) * D + (i / 4) * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(dkg + at) = __floats2bfloat162_rn(dk[i], dk[i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dvg + at) = __floats2bfloat162_rn(dv[i], dv[i + 1]);
  }
}

// lse and delta of rows [0, rep*bq) of a q tile; rows past sq read 0.
__device__ void load_row_stats(float* lse_s, float* delta_s, const Args& a, int g, int q0) {
  const int M = a.rep * a.bq;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const int pos = q0 + m % a.bq;
    const size_t at = (static_cast<size_t>(g) * a.rep + m / a.bq) * a.sq + pos;
    lse_s[m] = pos < a.sq ? a.lse[at] : 0.f;
    delta_s[m] = pos < a.sq ? a.delta[at] : 0.f;
  }
}

// p and ds of one score tile (s_s holds q.k, dp_s holds do.v): p = exp(s - lse)
// masked, ds = p * (dp - delta) * scale, both zero on rows past sq and on keys
// past sk.  Writes p (if p_s is given) and ds, each rounded to T.
template <typename T>
__device__ void p_and_ds(const float* s_s, float* dp_s, T* p_s, T* ds_s, const float* lse_s,
                         const float* delta_s, const Args& a, int q0, int k0) {
  const int M = a.rep * a.bq;
  const int ldk = a.bk + kPad;
  for (int i = threadIdx.x; i < M * a.bk; i += kThreads) {
    const int m = i / a.bk, j = i % a.bk;
    const int q_pos = q0 + m % a.bq, k_pos = k0 + j;
    const float s = keep(a, q_pos, k_pos) ? s_s[m * ldk + j] * a.scale : kNegInf;
    float p = expf(s - lse_s[m]);
    float ds = p * (dp_s[m * ldk + j] - delta_s[m]) * a.scale;
    if (q_pos >= a.sq) p = ds = 0.f;
    if (k_pos >= a.sk) ds = 0.f;
    if (p_s != nullptr) p_s[m * ldk + j] = from_f<T>(p);
    ds_s[m * ldk + j] = from_f<T>(ds);
  }
}

// --------------------------------------------- B2 backward, dk/dv per k tile
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) hb_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.rep * a.bq;
  const int ldd = D + kPad, ldk = a.bk + kPad;
  T* q_s = reinterpret_cast<T*>(smem);   // [M][ldd]
  T* do_s = q_s + M * ldd;               // [M][ldd]
  T* k_s = do_s + M * ldd;               // [bk][ldd]
  T* v_s = k_s + a.bk * ldd;             // [bk][ldd]
  float* s_s = reinterpret_cast<float*>(v_s + a.bk * ldd);  // [M][ldk]
  float* dp_s = s_s + M * ldk;                              // [M][ldk]
  T* p_s = reinterpret_cast<T*>(dp_s + M * ldk);            // [M][ldk] p in do's dtype
  T* ds_s = p_s + M * ldk;                                  // [M][ldk] ds in q's dtype
  float* dk_s = reinterpret_cast<float*>(ds_s + M * ldk);   // [bk][ldd]
  float* dv_s = dk_s + a.bk * ldd;                          // [bk][ldd]
  float* lse_s = dv_s + a.bk * ldd;                         // [M]
  float* delta_s = lse_s + M;                               // [M]

  const int g = blockIdx.y;
  const int k0 = blockIdx.x * a.bk;
  const int tid = threadIdx.x;
  const size_t qoff = static_cast<size_t>(g) * a.rep * a.sq * D;
  const size_t koff = static_cast<size_t>(g) * a.sk * D;
  const T* qg = static_cast<const T*>(a.q) + qoff;
  const T* dog = static_cast<const T*>(a.dout) + qoff;

  load_k_rows<T, D>(k_s, static_cast<const T*>(a.k) + koff, a, k0);
  load_k_rows<T, D>(v_s, static_cast<const T*>(a.v) + koff, a, k0);
  for (int i = tid; i < 2 * a.bk * ldd; i += kThreads) dk_s[i] = 0.f;  // dk_s and dv_s

  const int nq = (a.sq + a.bq - 1) / a.bq;
  // causal: q tiles whose last position precedes k0 see none of these keys
  for (int qt = a.causal ? k0 / a.bq : 0; qt < nq; ++qt) {
    const int q0 = qt * a.bq;
    __syncthreads();  // the previous tile's readers of q_s, do_s, p_s, ds_s are done
    load_q_rows<T, D>(q_s, qg, a, q0);
    load_q_rows<T, D>(do_s, dog, a, q0);
    load_row_stats(lse_s, delta_s, a, g, q0);
    __syncthreads();
    Mma<T>::abt(s_s, ldk, q_s, ldd, k_s, ldd, M, a.bk, D);
    Mma<T>::abt(dp_s, ldk, do_s, ldd, v_s, ldd, M, a.bk, D);
    __syncthreads();
    p_and_ds<T>(s_s, dp_s, p_s, ds_s, lse_s, delta_s, a, q0, k0);
    __syncthreads();
    // the contraction runs over all M rows: the sum over the group's rep heads
    Mma<T>::atb_acc(dv_s, ldd, p_s, ldk, do_s, ldd, a.bk, D, M);
    Mma<T>::atb_acc(dk_s, ldd, ds_s, ldk, q_s, ldd, a.bk, D, M);
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

// ------------------------------------------------ B2 backward, dq per q tile
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) hb_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = a.rep * a.bq;
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

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * a.bq;
  const int tid = threadIdx.x;
  const size_t qoff = static_cast<size_t>(g) * a.rep * a.sq * D;
  const size_t koff = static_cast<size_t>(g) * a.sk * D;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const T* vg = static_cast<const T*>(a.v) + koff;

  load_q_rows<T, D>(q_s, static_cast<const T*>(a.q) + qoff, a, q0);
  load_q_rows<T, D>(do_s, static_cast<const T*>(a.dout) + qoff, a, q0);
  load_row_stats(lse_s, delta_s, a, g, q0);
  for (int i = tid; i < M * ldd; i += kThreads) dq_s[i] = 0.f;

  const int nk = k_tiles(a, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * a.bk;
    __syncthreads();  // the previous tile's readers of k_s, v_s, ds_s are done
    load_k_rows<T, D>(k_s, kg, a, k0);
    load_k_rows<T, D>(v_s, vg, a, k0);
    __syncthreads();
    Mma<T>::abt(s_s, ldk, q_s, ldd, k_s, ldd, M, a.bk, D);
    Mma<T>::abt(dp_s, ldk, do_s, ldd, v_s, ldd, M, a.bk, D);
    __syncthreads();
    p_and_ds<T>(s_s, dp_s, static_cast<T*>(nullptr), ds_s, lse_s, delta_s, a, q0, k0);
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

// Dynamic shared memory of each kernel: the layouts above, in bytes
// (ops/flash_attention.py smem_bytes mirrors this to pick the tiles).
enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

size_t smem_bytes(Kind kind, const Args& a, int d, size_t t) {
  const size_t m = static_cast<size_t>(a.rep) * a.bq, bk = a.bk;
  const size_t ldd = d + kPad, ldk = bk + kPad;
  switch (kind) {
    case kFwd: return t * (m + 2 * bk) * ldd + 4 * m * ldk + t * m * ldk + 4 * m * ldd + 12 * m;
    case kDq: return t * (2 * m + 2 * bk) * ldd + 8 * m * ldk + t * m * ldk + 4 * m * ldd + 8 * m;
    default: return t * (2 * m + 2 * bk) * ldd + 8 * m * ldk + 2 * t * m * ldk + 8 * bk * ldd + 8 * m;
  }
}

template <typename T, int D>
cudaError_t launch(Kind kind, const Args& a, int groups, cudaStream_t stream) {
  const size_t smem = smem_bytes(kind, a, D, sizeof(T));
  const int m = a.rep * a.bq;
  if (smem > kSmemLimit || a.bq <= 0 || a.bk <= 0) return cudaErrorInvalidValue;
  // tensor-core tiles: 16-row multiples for every product's operands
  if (sizeof(T) == 2 && (m % 16 != 0 || a.bk % 16 != 0)) return cudaErrorInvalidValue;
  // bf16 at d 64 and 128 runs the wgmma kernels (launch_fwd_wgmma,
  // launch_bwd_wgmma): no shared-memory instantiation of those
  if constexpr (sizeof(T) == 2 && D >= 64) {
    return cudaErrorInvalidValue;
  } else {
    void (*kernel)(Args) = kind == kDq    ? hb_dq_kernel<T, D>
                           : kind == kDkv ? hb_dkv_kernel<T, D>
                                          : hb_fwd_kernel<T, D>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const int tiles = kind == kDkv ? (a.sk + a.bk - 1) / a.bk : (a.sq + a.bq - 1) / a.bq;
    kernel<<<dim3(tiles, groups), kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_d(Kind kind, const Args& a, int groups, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(kind, a, groups, s);
    case 32: return launch<T, 32>(kind, a, groups, s);
    case 64: return launch<T, 64>(kind, a, groups, s);
    case 128: return launch<T, 128>(kind, a, groups, s);
    default: return cudaErrorInvalidValue;
  }
}

// B1 on wgmma: bf16, d 64 or 128, a.bk == kFwdBK, rep * bq <= 128.  The
// tensor maps: q as (d, sq, rep, groups), k and v as (d, sk, groups).
template <int D>
cudaError_t launch_fwd_wgmma(const Args& a, int groups, cudaStream_t stream) {
  using L = FwdWgmmaSmem<D>;
  if (a.bk != kFwdBK || a.bq <= 0 || a.rep * a.bq > kFwdRows) return cudaErrorInvalidValue;
  const uint64_t row = D * 2;
  const uint64_t sk = a.sk > 0 ? a.sk : 1;  // no k tile is loaded when sk is 0
  const uint64_t qd[4] = {D, static_cast<uint64_t>(a.sq), static_cast<uint64_t>(a.rep),
                          static_cast<uint64_t>(groups)};
  const uint64_t qs[3] = {row, row * a.sq, row * a.sq * a.rep};
  const uint32_t qb[4] = {64, static_cast<uint32_t>(a.bq), static_cast<uint32_t>(a.rep), 1};
  const uint64_t kd[3] = {D, sk, static_cast<uint64_t>(groups)};
  const uint64_t ks[2] = {row, row * sk};
  const uint32_t kb[3] = {64, kFwdBK, 1};
  CUtensorMap tq, tk, tv;
  cudaError_t e = encode_bf16_map(&tq, a.q, 4, qd, qs, qb);
  if (e == cudaSuccess) e = encode_bf16_map(&tk, a.k, 3, kd, ks, kb);
  if (e == cudaSuccess) e = encode_bf16_map(&tv, a.v, 3, kd, ks, kb);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(hb_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes);
  if (e != cudaSuccess) return e;
  const int nq = (a.sq + a.bq - 1) / a.bq;
  hb_fwd_wgmma_kernel<D><<<nq * groups, kFwdThreads, L::kBytes, stream>>>(tq, tk, tv, a, groups);
  return cudaGetLastError();
}

// B2 on wgmma: bf16, d 64 or 128; dk/dv with a.bk == kBwdRows keys and
// q tiles of bq_kv positions (rep * bq_kv <= 64 rows), then dq with a.bk ==
// kBwdTile keys and q tiles of bq_q positions (rep * bq_q <= 128 rows).
// The tensor maps: q and do as (d, sq, rep, groups), k and v as (d, sk,
// groups), one box shape per kernel.
template <int D>
cudaError_t launch_bwd_wgmma(Args a, int groups, int bq_kv, int bk_kv, int bq_q, int bk_q,
                             cudaStream_t stream) {
  using L = BwdWgmmaSmem<D>;
  if (bk_kv != kBwdRows || bk_q != kBwdTile || bq_kv <= 0 || bq_q <= 0 ||
      a.rep * bq_kv > kBwdTile || a.rep * bq_q > kBwdRows)
    return cudaErrorInvalidValue;
  const uint64_t row = D * 2;
  const uint64_t sk = a.sk > 0 ? a.sk : 1;
  const uint64_t qd[4] = {D, static_cast<uint64_t>(a.sq), static_cast<uint64_t>(a.rep),
                          static_cast<uint64_t>(groups)};
  const uint64_t qs[3] = {row, row * a.sq, row * a.sq * a.rep};
  const uint64_t kd[3] = {D, sk, static_cast<uint64_t>(groups)};
  const uint64_t ks[2] = {row, row * sk};
  CUtensorMap maps[8];  // dk/dv: q, do, k, v; then dq's
  for (int kind = 0; kind < 2; ++kind) {
    const uint32_t qb[4] = {64, static_cast<uint32_t>(kind == 0 ? bq_kv : bq_q),
                            static_cast<uint32_t>(a.rep), 1};
    const uint32_t kb[3] = {64, static_cast<uint32_t>(kind == 0 ? kBwdRows : kBwdTile), 1};
    CUtensorMap* m = maps + 4 * kind;
    cudaError_t e = encode_bf16_map(&m[0], a.q, 4, qd, qs, qb);
    if (e == cudaSuccess) e = encode_bf16_map(&m[1], a.dout, 4, qd, qs, qb);
    if (e == cudaSuccess) e = encode_bf16_map(&m[2], a.k, 3, kd, ks, kb);
    if (e == cudaSuccess) e = encode_bf16_map(&m[3], a.v, 3, kd, ks, kb);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(hb_dkv_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDkvBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(hb_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kDqBytes);
  if (e != cudaSuccess) return e;
  a.bq = bq_kv;
  a.bk = bk_kv;
  const int nk = (a.sk + kBwdRows - 1) / kBwdRows;
  hb_dkv_wgmma_kernel<D><<<nk * groups, kBwdThreads, L::kDkvBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a, groups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  a.bq = bq_q;
  a.bk = bk_q;
  const int nq = (a.sq + bq_q - 1) / bq_q;
  hb_dq_wgmma_kernel<D><<<nq * groups, kBwdThreads, L::kDqBytes, stream>>>(
      maps[4], maps[5], maps[6], maps[7], a, groups);
  return cudaGetLastError();
}

cudaError_t dispatch(Kind kind, const Args& a, int groups, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(kind, a, groups, d, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(kind, a, groups, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// _hb_flash_forward: q [groups, rep, sq, d]; k/v [groups, sk, d] -> o (q's
// shape and dtype), lse [groups, rep, sq] fp32.
// wgmma: 1 takes hb_fwd_wgmma_kernel (bf16, d 64 or 128; the wrapper's
// rule), 0 the wmma / CUDA-core hb_fwd_kernel.
int pt_hb_flash_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                        int groups, int rep, int sq, int sk, int d, int bq, int bk, int causal,
                        float scale, int dtype, int wgmma, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = static_cast<float*>(lse);
  a.rep = rep;
  a.sq = sq;
  a.sk = sk;
  a.bq = bq;
  a.bk = bk;
  a.causal = causal;
  a.scale = scale;
  if (wgmma) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype != kBF16) return cudaErrorInvalidValue;
    if (d == 64) return launch_fwd_wgmma<64>(a, groups, st);
    if (d == 128) return launch_fwd_wgmma<128>(a, groups, st);
    return cudaErrorInvalidValue;
  }
  return dispatch(kFwd, a, groups, d, dtype, stream);
}

// _hb_flash_backward: (q, k, v, do, lse, delta) -> dq (q's shape), dk, dv
// (k's shape, summed over each group's rep heads).  Two launches on the
// stream: dk/dv with tiles (bq_kv, bk_kv), then dq with (bq_q, bk_q).
// wgmma: 1 takes hb_dkv_wgmma_kernel and hb_dq_wgmma_kernel (bf16, d 64 or
// 128; the wrapper's bwd_route), 0 the wmma / CUDA-core hb_dkv_kernel and
// hb_dq_kernel.
int pt_hb_flash_backward(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         int groups, int rep, int sq, int sk, int d, int bq_kv, int bk_kv,
                         int bq_q, int bk_q, int causal, float scale, int dtype, int wgmma,
                         void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.rep = rep;
  a.sq = sq;
  a.sk = sk;
  a.causal = causal;
  a.scale = scale;
  if (wgmma) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype != kBF16) return cudaErrorInvalidValue;
    if (d == 64) return launch_bwd_wgmma<64>(a, groups, bq_kv, bk_kv, bq_q, bk_q, st);
    if (d == 128) return launch_bwd_wgmma<128>(a, groups, bq_kv, bk_kv, bq_q, bk_q, st);
    return cudaErrorInvalidValue;
  }
  a.bq = bq_kv;
  a.bk = bk_kv;
  cudaError_t e = dispatch(kDkv, a, groups, d, dtype, stream);
  if (e != cudaSuccess) return e;
  a.bq = bq_q;
  a.bk = bk_q;
  return dispatch(kDq, a, groups, d, dtype, stream);
}

}  // extern "C"
