// Grouped (segmented) matmul for Hopper (sm_90a): the expert GEMMs of the
// dropless MoE block and of sparse serving, with a plain C interface loaded
// through ctypes (paddle_tpu_torch/ops/_build.py builds this file with nvcc).
//
// Replaces the two Pallas TPU kernel bodies of
// paddle_tpu/ops/pallas/grouped_matmul.py:
//   - _gmm_kernel (launcher grouped_matmul_raw, B7)   -> pt_grouped_matmul:
//       y[win_s] = x[win_s] @ w[wid_s] per segment s, or w[wid_s]^T (the
//       backward's dx, the bank read in place).  Kernel gmm_wgmma_kernel for
//       bf16 x over a bf16 bank, gmm_int8_wgmma_kernel (with
//       gmm_split_reduce_kernel when K is split) for bf16 x over an int8
//       bank with its per-(slice, out-channel) fp32 scales, gmm_kernel for
//       fp32 x (the wrapper's gmm_route);
//   - _outer_kernel (launcher grouped_outer_raw, B8)  -> pt_grouped_outer:
//       out[s] = x[win_s]^T @ dy[win_s], fp32 [S, K, N]; kernel
//       outer_wgmma_kernel for bf16, outer_kernel (CUDA cores) for fp32.
//
// A segment's window is the TPU's: whole block_rows blocks from its start's
// block, align(len, block_rows) rows, cut at R.  Rows no segment covers are
// left to the caller's zero fill (the wrapper allocates y with zeros).
// Segments whose weight id lies outside [0, E) are skipped.
//
// What bounds it on the H100.  At serving decode (8 slots x top-2 = 16 rows
// over 8 experts) B7 is a weight stream: every expert's [K, N] slice is read
// once, 2 * 16 * K * N operations on K * N bytes (int8), far below the
// card's ~295 operations per byte, so bytes bound it.  At the train cell
// (16384 rows over 8 experts, K/N 4096/14336) B7 and B8 are large GEMMs:
// B7 does 1.92 TFLOP on ~1.5 GB (x 0.13, the bank 0.94, y 0.47), 1.95 ms of
// operations against 0.46 ms of bytes, so operations bound it and every
// byte staged in shared memory has to feed many products.  The design:
//   - B7 bf16 (gmm_wgmma_kernel, on the Hopper blocks of hopper.cuh): one
//     CTA per 128-row x 256-column output tile of one segment's window, the
//     tiles walked in groups of 8 N tiles with the row tiles inside so the
//     CTAs in flight share x and weight slabs in L2.  The grid counts
//     R / 128 + S row tiles times the N tiles, the most the segments can
//     need; each CTA walks the segment table in device memory to find its
//     segment and tile (no host sync sizes anything) and exits past the
//     last.  A producer warp keeps 4 stages of 64-deep K steps in flight by
//     TMA: x's 128 window rows (K-major) and the weight tile, read through
//     one 3-D tensor map over the bank with the expert as third coordinate:
//     the forward's w[wid][k0:+64, n0:+256] as four MN-major 64-column
//     panels, dx's w[wid][n0:+256, k0:+64] as one K-major panel of 256 rows
//     (its contraction axis is contiguous: no transposed copy).  Two
//     consumer warpgroups run m64n256k16 wgmma into 128 fp32 registers a
//     thread, one group left in flight.  TMA zero-fills past R, K and N;
//     rows of the next segment are multiplied but never stored (the
//     epilogue masks rows at or past start + align(len)), and no row of y
//     depends on another, so nothing needs zeroing in shared memory;
//   - B7 int8 (gmm_int8_wgmma_kernel): the int8 bank is a stream (46.7 GB of
//     Mixtral's experts, read in place in its [E, K, N] layout: no repacked
//     copy fits beside it), and a decode segment has 1-16 rows.  So the
//     product runs swapped, y^T[n, rows] = w^T[n, k] x^T[k, rows]: the
//     widened weight is wgmma's 64-row A operand and the segment's rows its
//     narrow N (16, 64 or 128, picked on the host from R and S alone), so
//     no row is padded to 64.  One CTA per (row tile of one segment, K
//     split, 128 output columns), in the order the host's plan picks: row
//     tiles innermost where the segments average more than two row tiles
//     (prefill), so the tiles of one segment read each weight tile close
//     together, else column tiles innermost (the CTAs in flight read
//     neighbouring pieces of the same bank rows).
//     A producer warp keeps 7 (row tile 16) or 4 stages in flight by TMA:
//     the int8 tile w[wid][k0:+64, n0:+128] through an 8-bit tensor map over the bank
//     (128-byte swizzle, the expert as third coordinate) and x's rows
//     [NR][64].  Two CTAs fit an SM at row tiles 16 and 64, so 112 KB of
//     weight bytes are in flight per SM at decode.  Each consumer
//     warpgroup widens its 64 columns of the tile to bf16 (exact, a byte
//     permute and one fp32 subtraction per element, widen_i8x4) into a
//     swizzled panel of its own (two alternate), then runs 4 m64nNRk16
//     products, A MN-major from the panel, B K-major from x's rows, one
//     group left in flight.  The fp32 sums are multiplied by
//     w_scale[wid, n] and cast to bf16, the TPU's order.  Where the grid
//     would not fill the card (the down projection: K 14336, N 4096 gives
//     32 column tiles per expert) K is split: each split stores its fp32
//     sums in a scratch the wrapper allocates, and gmm_split_reduce_kernel
//     adds them in split order before the scale and the cast
//     (deterministic, no atomics);
//   - B7 fp32 (gmm_kernel): one CTA per (row tile of 64 rows of one
//     segment, N tile of 64), the same segment walk; the CTA loops over K
//     in steps of 64, staging the x rows and the weight tile in shared
//     memory, the next step's tiles loaded into registers while the CUDA
//     cores multiply the current ones (a 4x4 micro-tile per thread).  An
//     int8 bank under fp32 x is widened as it is stored to shared memory
//     and its scale applied to the fp32 sums.  The transposed launch stores
//     the tile of w[wid] ([N, K] rows, read contiguously along K)
//     column-major in shared memory;
//   - B8 bf16 (outer_wgmma_kernel, on hopper.cuh).  At the train cell's dW
//     it does 1.92 TFLOP on 0.6 GB of distinct input and 1.9 GB of fp32
//     output: 1.95 ms of operations against 0.75 ms of bytes.  One CTA per
//     128 x 256 output tile of one segment (85 flop per staged byte), its
//     tiles walked in groups of 8 N tiles with the K tiles inside; a
//     producer warp keeps 4 stages of 64 window rows in flight by TMA; two
//     consumer warpgroups run m64n256k16 wgmma on them, x^T and dy both read
//     as MN-major operands of the row-major tiles (no transposed copy), with
//     128 fp32 accumulators a thread in registers.  The window's last step
//     zeroes the rows that belong to the next segment in shared memory, then
//     fences them to the async proxy, before the products read them.  Every
//     tile is stored, an empty segment's as exact zeros.  No atomics:
//     deterministic.  fp32 keeps the CUDA-core outer_kernel (one CTA per
//     64 x 64 tile, chunks of 32 rows).
// Left for later work: a persistent grid with the epilogue overlapping the
// next tile's loads; B7 int8's epilogue stores single bf16 values (the
// swapped product leaves a thread's consecutive registers on consecutive
// rows), a transpose through shared memory would store rows whole.

#include <type_traits>

#include "flash_common.cuh"  // kThreads, kPad, dtype helpers
#include "hopper.cuh"        // TMA, mbarriers, wgmma (B7 and B8 bf16, B7 int8)

namespace {

constexpr int kBM = 64;   // rows of a gmm_kernel tile (fp32 x)
constexpr int kBN = 64;   // columns of a tile
constexpr int kBK = 64;   // K step of B7; K tile of B8
constexpr int kBR = 32;   // rows per step of B8
constexpr int kLdo = kBN + 4;  // fp32 staging of the output tile

__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// eight consecutive elements, moved with one or two vector accesses
template <typename U>
struct alignas(16) Chunk {
  U v[8];
};

template <typename U>
__device__ __forceinline__ void load_chunk(Chunk<U>& c, const U* p, bool ok) {
  static_assert(sizeof(U) == 1 || sizeof(U) == 2 || sizeof(U) == 4, "element size");
  if constexpr (sizeof(U) == 1) {
    *reinterpret_cast<uint2*>(c.v) = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0, 0);
  } else if constexpr (sizeof(U) == 2) {
    *reinterpret_cast<uint4*>(c.v) =
        ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
  } else {
    const uint4 z = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(c.v)[0] = ok ? reinterpret_cast<const uint4*>(p)[0] : z;
    reinterpret_cast<uint4*>(c.v)[1] = ok ? reinterpret_cast<const uint4*>(p)[1] : z;
  }
}

// store a chunk of U as eight T (widening an int8 bank to x's dtype)
template <typename T, typename U>
__device__ __forceinline__ void store_chunk(T* dst, const Chunk<U>& c) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = from_f<T>(to_f(c.v[i]));
}

struct GmmArgs {
  const void* x;        // [R, K] T
  const void* w;        // [E, K, N] (or [E, N, K] transposed) T or int8
  const float* scale;   // [E, N] or nullptr
  void* y;              // [R, N] T, zero-filled by the wrapper
  const int* starts;    // [S]
  const int* lens;      // [S]
  const int* wids;      // [S]
  int R, K, N, S, E, br;
};

// The segment and row range of the CTA's row tile g of BM rows: segments in
// order, each contributing ceil(align(len, br) / BM) tiles.  False past the
// last.
template <int BM>
__device__ bool find_tile(const GmmArgs& a, int g, int& seg, int& row0, int& row_end) {
  int cum = 0;
  for (int s = 0; s < a.S; ++s) {
    const int len = max(a.lens[s], 0);
    const int alen = (len + a.br - 1) / a.br * a.br;
    const int nt = (alen + BM - 1) / BM;
    if (g < cum + nt) {
      const int base = a.starts[s] / a.br * a.br;
      seg = s;
      row0 = base + (g - cum) * BM;
      row_end = min(base + alen, a.R);
      return true;
    }
    cum += nt;
  }
  return false;
}

template <typename T, typename TW, bool TRANS>
struct GmmSmem {
  static constexpr int kLdx = kBK + kPad;                   // xs [kBM][kLdx]
  static constexpr int kLdw = TRANS ? kBK + kPad : kBN + kPad;
  static constexpr int kWRows = TRANS ? kBN : kBK;          // ws [kWRows][kLdw]
  static constexpr int kTiles = (kBM * kLdx + kWRows * kLdw) * int(sizeof(T));
  static constexpr int kOut = kBM * kLdo * 4;
  static constexpr int kBytes = kTiles > kOut ? kTiles : kOut;
};

template <typename T, typename TW, bool TRANS>
__global__ void __launch_bounds__(kThreads) gmm_kernel(GmmArgs a) {
  using L = GmmSmem<T, TW, TRANS>;
  __shared__ __align__(128) unsigned char smem[L::kBytes];
  int seg, row0, row_end;
  if (!find_tile<kBM>(a, blockIdx.y, seg, row0, row_end)) return;
  const int wid = a.wids[seg];
  if (wid < 0 || wid >= a.E) return;
  const int n0 = blockIdx.x * kBN;
  const T* x = static_cast<const T*>(a.x);
  const TW* w = static_cast<const TW*>(a.w) + static_cast<size_t>(wid) * a.K * a.N;
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + kBM * L::kLdx;
  float* os = reinterpret_cast<float*>(smem);  // after the K loop

  // each thread moves chunks t and t + kThreads of both tiles (64 x 64 / 8)
  Chunk<T> xr[2];
  Chunk<TW> wr[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int r = c >> 3, col = (c & 7) * 8;
      const int row = row0 + r, k = k0 + col;
      load_chunk(xr[u], x + static_cast<size_t>(row) * a.K + k, row < row_end && k < a.K);
      if constexpr (TRANS) {  // tile row r = n, contiguous along k
        const int n = n0 + r;
        load_chunk(wr[u], w + static_cast<size_t>(n) * a.K + k, n < a.N && k < a.K);
      } else {                // tile row r = k, contiguous along n
        const int kk = k0 + r, n = n0 + col;
        load_chunk(wr[u], w + static_cast<size_t>(kk) * a.N + n, kk < a.K && n < a.N);
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = threadIdx.x + u * kThreads;
      const int r = c >> 3, col = (c & 7) * 8;
      store_chunk(xs + r * L::kLdx + col, xr[u]);
      store_chunk(ws + r * L::kLdw + col, wr[u]);
    }
  };

  static_assert(std::is_same<T, float>::value, "bf16 x runs a wgmma kernel");
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;  // 4x4 outputs
  float acc[4][4] = {};

  load(0);
  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    __syncthreads();  // the previous step's products are done with the tiles
    stage();
    __syncthreads();
    if (k0 + kBK < a.K) load(k0 + kBK);  // in flight during the products
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = to_f(xs[(tr * 4 + i) * L::kLdx + kk]);
        bv[i] = TRANS ? to_f(ws[(tc * 4 + i) * L::kLdw + kk])
                      : to_f(ws[kk * L::kLdw + tc * 4 + i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }

  __syncthreads();  // the tiles' region becomes the fp32 output staging
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) os[(tr * 4 + i) * kLdo + tc * 4 + j] = acc[i][j];
  __syncthreads();
  T* y = static_cast<T*>(a.y);
  for (int c = threadIdx.x; c < kBM * kBN / 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int row = row0 + r, n = n0 + col;
    if (row >= row_end || n >= a.N) continue;
    Chunk<T> out;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = os[r * kLdo + col + i];
      if (a.scale != nullptr) v *= a.scale[static_cast<size_t>(wid) * a.N + n + i];
      out.v[i] = from_f<T>(v);
    }
    T* dst = y + static_cast<size_t>(row) * a.N + n;
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(out.v)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(out.v)[1];
  }
}

struct OuterArgs {
  const void* x;       // [R, K] T
  const void* dy;      // [R, N] T
  float* out;          // [S, K, N]
  const int* starts;   // [S]
  const int* lens;     // [S]
  int R, K, N, S, br;
};

// B8 for fp32 on the CUDA cores: one CTA per (segment, K tile of 64, N
// tile of 64), a 4x4 micro-tile per thread, the window in chunks of 32 rows
__global__ void __launch_bounds__(kThreads) outer_kernel(OuterArgs a) {
  constexpr int kLd = kBK + kPad;  // xs, ds [kBR][kLd] (kBK == kBN)
  constexpr int kTiles = 2 * kBR * kLd * 4;
  constexpr int kOut = kBK * kLdo * 4;
  __shared__ __align__(128) unsigned char smem[kTiles > kOut ? kTiles : kOut];
  const int s = blockIdx.z, k0 = blockIdx.y * kBK, n0 = blockIdx.x * kBN;
  const int len = max(a.lens[s], 0);
  const int alen = (len + a.br - 1) / a.br * a.br;
  const int base = a.starts[s] / a.br * a.br;
  const int row_end = min(base + alen, a.R);
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  float* xs = reinterpret_cast<float*>(smem);
  float* ds = xs + kBR * kLd;
  float* os = reinterpret_cast<float*>(smem);

  // one chunk of each tile per thread (32 x 64 / 8 = 256)
  const int r = threadIdx.x >> 3, col = (threadIdx.x & 7) * 8;
  Chunk<float> xr, dr;
  auto load = [&](int r0) {
    const int row = r0 + r;
    const bool ok = row < row_end;
    load_chunk(xr, x + static_cast<size_t>(row) * a.K + k0 + col, ok && k0 + col < a.K);
    load_chunk(dr, dy + static_cast<size_t>(row) * a.N + n0 + col, ok && n0 + col < a.N);
  };

  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float acc[4][4] = {};
  if (base < row_end) load(base);
  for (int r0 = base; r0 < row_end; r0 += kBR) {
    __syncthreads();
    store_chunk(xs + r * kLd + col, xr);
    store_chunk(ds + r * kLd + col, dr);
    __syncthreads();
    if (r0 + kBR < row_end) load(r0 + kBR);
#pragma unroll 4
    for (int rr = 0; rr < kBR; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = xs[rr * kLd + tr * 4 + i];
        bv[i] = ds[rr * kLd + tc * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) os[(tr * 4 + i) * kLdo + tc * 4 + j] = acc[i][j];
  __syncthreads();
  // every tile is stored, an empty segment's as zeros
  float* out = a.out + static_cast<size_t>(s) * a.K * a.N;
  for (int c = threadIdx.x; c < kBK * kBN / 8; c += kThreads) {
    const int kr = c >> 3, cc = (c & 7) * 8;
    const int k = k0 + kr, n = n0 + cc;
    if (k >= a.K || n >= a.N) continue;
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(k) * a.N + n);
    const float* src = os + kr * kLdo + cc;
    dst[0] = make_float4(src[0], src[1], src[2], src[3]);
    dst[1] = make_float4(src[4], src[5], src[6], src[7]);
  }
}

// ------------------------------------------------------ B8, bf16 on wgmma
constexpr int kOutBM = 128;      // K rows of an output tile: two consumer warpgroups
constexpr int kOutBN = 256;      // N columns of an output tile
constexpr int kOutBR = 64;       // window rows per pipeline step
constexpr int kOutStages = 4;
constexpr int kOutThreads = 288; // two consumer warpgroups, then one producer warp
constexpr int kOutGroup = 8;     // N tiles walked together, K tiles inside (L2 reuse)
constexpr int kOutPanel = kOutBR * 128;                          // [64 rows][64] bf16
constexpr int kOutStage = (kOutBM / 64 + kOutBN / 64) * kOutPanel;  // x panels, then dy
constexpr int kOutSmem = kOutStages * kOutStage + 1024;

// One CTA per output tile (segment s, 128 K rows, 256 N columns); tiles of
// one segment in groups of kOutGroup N tiles with the K tiles inside, so
// the CTAs in flight share x and dy slabs in L2.  Warp 8 is the producer:
// per step, TMA loads of the window's next 64 rows of x (two 64-column
// panels) and dy (four), zero past R and past K or N, through a
// kOutStages ring.  Warpgroup w multiplies x panel w (A = x^T, MN-major:
// the transpose bit reads the row-major rows as columns) by the dy tile (B,
// MN-major, 256 wide over four panels) into 128 fp32 registers a thread,
// one wgmma group left in flight.  The window's last step zeroes its rows
// past the window's end (the next segment's) in shared memory before the
// products read them.  Every element is stored: an empty segment's as 0.
__global__ void __launch_bounds__(kOutThreads, 1)
    outer_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tdy, OuterArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kOutStages];
  unsigned char* ring = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* full = bars;
  uint64_t* empty = bars + kOutStages;

  const int nkt = (a.K + kOutBM - 1) / kOutBM, nnt = (a.N + kOutBN - 1) / kOutBN;
  const int s = blockIdx.x / (nkt * nnt);
  const int t = blockIdx.x % (nkt * nnt);
  const int grp = t / (kOutGroup * nkt);
  const int gw = min(kOutGroup, nnt - grp * kOutGroup);
  const int in_grp = t - grp * kOutGroup * nkt;
  const int k0 = in_grp / gw * kOutBM, n0 = (grp * kOutGroup + in_grp % gw) * kOutBN;
  const int len = max(a.lens[s], 0);
  const int base = a.starts[s] / a.br * a.br;
  const int row_end = min(base + (len + a.br - 1) / a.br * a.br, a.R);
  const int steps = row_end > base ? (row_end - base + kOutBR - 1) / kOutBR : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kOutStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      for (int c = 0; c < steps; ++c) {
        const int st = c % kOutStages, r0 = base + c * kOutBR;
        mbar_wait(&empty[st], ((c / kOutStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kOutStage);
        unsigned char* dst = ring + st * kOutStage;
        for (int p = 0; p < kOutBM / 64; ++p)
          tma_load_2d(dst + p * kOutPanel, &tx, &full[st], k0 + 64 * p, r0);
        for (int p = 0; p < kOutBN / 64; ++p)
          tma_load_2d(dst + (kOutBM / 64 + p) * kOutPanel, &tdy, &full[st], n0 + 64 * p, r0);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  float acc[kOutBN / 2];
#pragma unroll
  for (int i = 0; i < kOutBN / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < steps; ++c) {
    const int st = c % kOutStages;
    unsigned char* tile = ring + st * kOutStage;
    mbar_wait(&full[st], (c / kOutStages) & 1);
    const int valid = row_end - (base + c * kOutBR);
    if (valid < kOutBR) {
      // rows [valid, 64) of every panel belong to the next segment
      constexpr int kPanels = kOutStage / kOutPanel;
      const int chunks = (kOutBR - valid) * 8;  // 16-byte chunks of one panel
      for (int i = threadIdx.x; i < kPanels * chunks; i += 256)
        *reinterpret_cast<uint4*>(tile + (i / chunks) * kOutPanel + valid * 128 +
                                  (i % chunks) * 16) = make_uint4(0, 0, 0, 0);
      fence_proxy_async();
      named_barrier(1, 256);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kOutBR / 16; ++ks) {
      const uint64_t da = smem_desc(tile + wg * kOutPanel + ks * 16 * 128, kOutPanel, 1024);
      const uint64_t db =
          smem_desc(tile + (kOutBM / 64) * kOutPanel + ks * 16 * 128, kOutPanel, 1024);
      wgmma_ss_n256<1, 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their stage
    if (c > 0) mbar_arrive(&empty[(c - 1) % kOutStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float* out = a.out + static_cast<size_t>(s) * a.K * a.N;
#pragma unroll
  for (int i = 0; i < kOutBN / 2; i += 2) {
    const int k = k0 + wg * 64 + wq * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int n = n0 + (i / 4) * 8 + (lane % 4) * 2;
    if (k < a.K && n < a.N)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(k) * a.N + n) =
          make_float2(acc[i], acc[i + 1]);
  }
}

cudaError_t launch_outer_wgmma(const OuterArgs& a, cudaStream_t stream) {
  // x as (K, R), dy as (N, R); R is at least 1 for the map (no window has rows when it is 0)
  const uint64_t R = a.R > 0 ? a.R : 1;
  const uint64_t xd[2] = {static_cast<uint64_t>(a.K), R}, xs[1] = {2ull * a.K};
  const uint64_t dd[2] = {static_cast<uint64_t>(a.N), R}, ds[1] = {2ull * a.N};
  const uint32_t box[2] = {64, kOutBR};
  CUtensorMap tx, tdy;
  cudaError_t e = encode_bf16_map(&tx, a.x, 2, xd, xs, box);
  if (e == cudaSuccess) e = encode_bf16_map(&tdy, a.dy, 2, dd, ds, box);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(outer_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kOutSmem);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>((a.K + kOutBM - 1) / kOutBM) *
                          ((a.N + kOutBN - 1) / kOutBN) * a.S;
  if (tiles <= 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  outer_wgmma_kernel<<<static_cast<unsigned>(tiles), kOutThreads, kOutSmem, stream>>>(tx, tdy, a);
  return cudaGetLastError();
}

// ------------------------------------------------------ B7, bf16 on wgmma
constexpr int kGmmBM = 128;       // rows of a tile: two consumer warpgroups of 64
constexpr int kGmmBN = 256;       // output columns of a tile
constexpr int kGmmBK = 64;        // K per pipeline step
constexpr int kGmmStages = 4;
constexpr int kGmmThreads = 288;  // two consumer warpgroups, then one producer warp
constexpr int kGmmGroup = 8;      // N tiles walked together, row tiles inside (L2 reuse)
constexpr int kGmmPanel = 64 * 128;                // [64 rows][64] bf16
constexpr int kGmmX = kGmmBM * 128;                // x rows [128][64]
constexpr int kGmmStage = kGmmX + kGmmBN * kGmmBK * 2;  // x, then the weight tile
constexpr int kGmmSmem = kGmmStages * kGmmStage + 1024;

// One CTA per (row tile of 128 window rows of one segment, 256 output
// columns); N tiles in groups of kGmmGroup with the row tiles inside.  Warp
// 8 is the producer: per K step one TMA load of the x rows (64 columns of K)
// and of the weight tile (TRANS: w[wid] rows n0.. of [N, K], K-major, one
// 256-row panel; else rows k0.. of [K, N], four MN-major 64-column panels),
// zero past R, K and N, through a kGmmStages ring.  Warpgroup w multiplies
// x rows w*64.. (A, K-major) by the weight tile (B, 256 wide) into 128 fp32
// registers a thread, one wgmma group left in flight; the epilogue stores
// bf16 rows before the window's end and columns before N.
template <bool TRANS>
__global__ void __launch_bounds__(kGmmThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw, GmmArgs a, int row_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kGmmStages];
  unsigned char* ring = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* full = bars;
  uint64_t* empty = bars + kGmmStages;

  const int nnt = (a.N + kGmmBN - 1) / kGmmBN;
  const int t = blockIdx.x;
  const int grp = t / (kGmmGroup * row_tiles);
  const int gw = min(kGmmGroup, nnt - grp * kGmmGroup);
  const int in_grp = t - grp * kGmmGroup * row_tiles;
  const int n0 = (grp * kGmmGroup + in_grp % gw) * kGmmBN;
  int seg, row0, row_end;
  if (!find_tile<kGmmBM>(a, in_grp / gw, seg, row0, row_end) || a.wids[seg] < 0 ||
      a.wids[seg] >= a.E)
    return;
  const int wid = a.wids[seg];
  const int steps = (a.K + kGmmBK - 1) / kGmmBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGmmStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      for (int c = 0; c < steps; ++c) {
        const int st = c % kGmmStages, k0 = c * kGmmBK;
        mbar_wait(&empty[st], ((c / kGmmStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kGmmStage);
        unsigned char* dst = ring + st * kGmmStage;
        tma_load_2d(dst, &tx, &full[st], k0, row0);
        if constexpr (TRANS) {
          tma_load_3d(dst + kGmmX, &tw, &full[st], k0, n0, wid);
        } else {
          for (int p = 0; p < kGmmBN / 64; ++p)
            tma_load_3d(dst + kGmmX + p * kGmmPanel, &tw, &full[st], n0 + 64 * p, k0, wid);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  float acc[kGmmBN / 2];
#pragma unroll
  for (int i = 0; i < kGmmBN / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < steps; ++c) {
    const int st = c % kGmmStages;
    const unsigned char* tile = ring + st * kGmmStage;
    mbar_wait(&full[st], (c / kGmmStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kGmmBK / 16; ++ks) {
      const uint64_t da = smem_desc(tile + wg * 64 * 128 + ks * 32, 16, 1024);
      if constexpr (TRANS) {
        wgmma_ss_n256<0, 0>(acc, da, smem_desc(tile + kGmmX + ks * 32, 16, 1024), 1);
      } else {
        wgmma_ss_n256<0, 1>(acc, da, smem_desc(tile + kGmmX + ks * 16 * 128, kGmmPanel, 1024),
                            1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their stage
    if (c > 0) mbar_arrive(&empty[(c - 1) % kGmmStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
#pragma unroll
  for (int i = 0; i < kGmmBN / 2; i += 2) {
    const int row = row0 + wg * 64 + wq * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int n = n0 + (i / 4) * 8 + (lane % 4) * 2;
    if (row < row_end && n < a.N)
      *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(row) * a.N + n) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// B7 bf16 on wgmma: x as (K, R); the bank as (N, K, E) (forward) or
// (K, N, E) (TRANS, stored [E, N, K]).  R and K are at least 1 (the wrapper
// returns before a launch otherwise).
template <bool TRANS>
cudaError_t launch_gmm_wgmma(const GmmArgs& a, cudaStream_t stream) {
  const uint64_t K = a.K, N = a.N;
  const uint64_t xd[2] = {K, static_cast<uint64_t>(a.R)}, xs[1] = {2 * K};
  const uint32_t xb[2] = {64, kGmmBM};
  const uint64_t inner = TRANS ? K : N, outer = TRANS ? N : K;
  const uint64_t wd[3] = {inner, outer, static_cast<uint64_t>(a.E)};
  const uint64_t ws[2] = {2 * inner, 2 * inner * outer};
  const uint32_t wb[3] = {64, TRANS ? static_cast<uint32_t>(kGmmBN) : 64u, 1};
  CUtensorMap tx, tw;
  cudaError_t e = encode_bf16_map(&tx, a.x, 2, xd, xs, xb);
  if (e == cudaSuccess) e = encode_bf16_map(&tw, a.w, 3, wd, ws, wb);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gmm_wgmma_kernel<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGmmSmem);
  if (e != cudaSuccess) return e;
  const int row_tiles = (a.R + kGmmBM - 1) / kGmmBM + a.S;
  const long long tiles = static_cast<long long>(row_tiles) * ((a.N + kGmmBN - 1) / kGmmBN);
  if (tiles <= 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  gmm_wgmma_kernel<TRANS><<<static_cast<unsigned>(tiles), kGmmThreads, kGmmSmem, stream>>>(
      tx, tw, a, row_tiles);
  return cudaGetLastError();
}

// ---------------------------------------- B7 int8: bf16 x over an int8 bank
constexpr int kQBN = 128;          // output columns of a tile: one 128-byte int8 row
constexpr int kQBK = 64;           // K per pipeline step
constexpr int kQThreads = 288;     // two consumer warpgroups (64 columns each), one producer warp
constexpr int kQW = kQBK * kQBN;   // the int8 weight tile [64 k][128] of a stage
constexpr int kQPanel = 64 * 128;  // a widened bf16 panel [64 k][64]

// NR rows of a row tile (the products' N): 16 at decode, 64, 128
template <int NR>
struct QCfg {
  static constexpr int kStages = NR == 16 ? 7 : 4;
  static constexpr int kX = NR * 128;  // x rows [NR][64] bf16
  static constexpr int kStage = kQW + kX;
  // the ring, then two alternating widened panels per consumer warpgroup
  static constexpr int kSmem = kStages * kStage + 4 * kQPanel + 1024;
  static constexpr int kMinBlocks = NR == 128 ? 1 : 2;
};

// One CTA per (row tile rt of NR rows of one segment, K split, 128 output
// columns n0..), row tiles innermost when rows_inner, else column tiles;
// K splits outermost.  Warp 8 is the producer: per K step
// of 64, a TMA load of the int8 tile w[wid][k0:+64, n0:+128] (8-bit map,
// 128-byte swizzle) and of x's NR rows [row0:+NR, k0:+64] (bf16 map), zero
// past R, K and N, through a kStages ring.  Warpgroup g widens columns
// 64g.. of the int8 tile into its panel and multiplies it (A, MN-major:
// y^T's 64 output channels) by x's rows (B, K-major: NR rows) into NR / 2
// fp32 registers a thread.  splits == 1: y = bf16(sum * w_scale[wid, n]),
// rows before the window's end and columns before N; else the split's fp32
// sums go to part[split][R][N] for gmm_split_reduce_kernel.
template <int NR>
__global__ void __launch_bounds__(kQThreads, QCfg<NR>::kMinBlocks)
    gmm_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw, GmmArgs a, int row_tiles,
                          int splits, int rows_inner, float* part) {
  using C = QCfg<NR>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * C::kStages];
  unsigned char* ring = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* wide = ring + C::kStages * C::kStage;
  uint64_t* full = bars;
  uint64_t* empty = bars + C::kStages;

  const int t = blockIdx.x, n_tiles = (a.N + kQBN - 1) / kQBN, inner = t % (n_tiles * row_tiles);
  const int rt = rows_inner ? inner % row_tiles : inner / n_tiles;
  const int n0 = (rows_inner ? inner / row_tiles : inner % n_tiles) * kQBN;
  const int split = t / (n_tiles * row_tiles);
  int seg, row0, row_end;
  if (!find_tile<NR>(a, rt, seg, row0, row_end)) return;
  const int wid = a.wids[seg];
  if (wid < 0 || wid >= a.E) return;
  // this split's K steps [c0, c0 + steps); a split past K stores zeros
  const int all = (a.K + kQBK - 1) / kQBK, per = (all + splits - 1) / splits;
  const int c0 = min(split * per, all), steps = min(per, all - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      for (int c = 0; c < steps; ++c) {
        const int st = c % C::kStages, k0 = (c0 + c) * kQBK;
        mbar_wait(&empty[st], ((c / C::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], C::kStage);
        unsigned char* dst = ring + st * C::kStage;
        tma_load_3d(dst, &tw, &full[st], n0, k0, wid);
        tma_load_2d(dst + kQW, &tx, &full[st], k0, row0);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = threadIdx.x / 128, tq = threadIdx.x % 128, wq = tq / 32;
  float acc[NR / 2];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < steps; ++c) {
    const int st = c % C::kStages;
    const unsigned char* tile = ring + st * C::kStage;
    // the panel the products of step c - 2 read: done (waited below at c - 1)
    unsigned char* panel = wide + (2 * wg + (c & 1)) * kQPanel;
    mbar_wait(&full[st], (c / C::kStages) & 1);
    widen_i8_panel(tile, panel, wg, tq);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kQBK / 16; ++ks)
      wgmma_ss<NR, 1, 0>(acc, smem_desc(panel + ks * 16 * 128, kQPanel, 1024),
                         smem_desc(tile + kQW + ks * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their stage
    if (c > 0) mbar_arrive(&empty[(c - 1) % C::kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // register i: output channel n (rows of y^T), row r (its columns)
  const int n_lo = n0 + wg * 64 + wq * 16 + lane / 4;
  if (splits == 1) {
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
    const float* sc = a.scale + static_cast<size_t>(wid) * a.N;
    const float s0 = n_lo < a.N ? sc[n_lo] : 0.f, s1 = n_lo + 8 < a.N ? sc[n_lo + 8] : 0.f;
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) {
      const int n = n_lo + 8 * ((i / 2) % 2);
      const int row = row0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
      if (row < row_end && n < a.N)
        y[static_cast<size_t>(row) * a.N + n] = __float2bfloat16(acc[i] * ((i / 2) % 2 ? s1 : s0));
    }
  } else {
    float* out = part + static_cast<size_t>(split) * a.R * a.N;
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) {
      const int n = n_lo + 8 * ((i / 2) % 2);
      const int row = row0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
      if (row < row_end && n < a.N) out[static_cast<size_t>(row) * a.N + n] = acc[i];
    }
  }
}

// B7 int8's K splits added in split order: one CTA per (row, 1024 columns);
// the row's segment is the one whose window holds it (none, or a weight id
// outside [0, E): the row stays the wrapper's zero).  y = bf16(sum *
// w_scale[wid, n]).
__global__ void __launch_bounds__(256) gmm_split_reduce_kernel(GmmArgs a, int splits,
                                                               const float* part) {
  const int row = blockIdx.x;
  int wid = -1;
  for (int s = 0; s < a.S; ++s) {
    const int base = a.starts[s] / a.br * a.br;
    const int end = min(base + (max(a.lens[s], 0) + a.br - 1) / a.br * a.br, a.R);
    if (row >= base && row < end) {
      wid = a.wids[s];
      break;
    }
  }
  if (wid < 0 || wid >= a.E) return;
  const int n = (blockIdx.y * 256 + threadIdx.x) * 4;
  if (n >= a.N) return;
  const size_t at = static_cast<size_t>(row) * a.N + n, plane = static_cast<size_t>(a.R) * a.N;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 v = *reinterpret_cast<const float4*>(part + sp * plane + at);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  const float* sc = a.scale + static_cast<size_t>(wid) * a.N + n;
  __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.y) + at);
  y[0] = __floats2bfloat162_rn(sum.x * sc[0], sum.y * sc[1]);
  y[1] = __floats2bfloat162_rn(sum.z * sc[2], sum.w * sc[3]);
}

// B7 int8: x as (K, R) bf16; the bank as (N, K, E) bytes.  N % 16 == 0 (the
// bank's row stride), K % 8 == 0 (x's), both bases 16-byte aligned: the
// wrapper checks.  part: splits x R x N fp32 when splits > 1.
template <int NR>
cudaError_t launch_gmm_int8(const GmmArgs& a, int splits, int rows_inner, float* part,
                            cudaStream_t stream) {
  using C = QCfg<NR>;
  const uint64_t K = a.K, N = a.N;
  const uint64_t xd[2] = {K, static_cast<uint64_t>(a.R)}, xs[1] = {2 * K};
  const uint32_t xb[2] = {64, NR};
  const uint64_t wd[3] = {N, K, static_cast<uint64_t>(a.E)}, ws[2] = {N, N * K};
  const uint32_t wb[3] = {kQBN, kQBK, 1};
  if (splits < 1 || (splits > 1 && part == nullptr) || a.scale == nullptr)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  cudaError_t e = encode_bf16_map(&tx, a.x, 2, xd, xs, xb);
  if (e == cudaSuccess) e = encode_u8_map(&tw, a.w, 3, wd, ws, wb);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gmm_int8_wgmma_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem);
  if (e != cudaSuccess) return e;
  const int row_tiles = (a.R + NR - 1) / NR + a.S;
  const long long tiles = static_cast<long long>(row_tiles) * splits * ((a.N + kQBN - 1) / kQBN);
  if (tiles <= 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  gmm_int8_wgmma_kernel<NR><<<static_cast<unsigned>(tiles), kQThreads, C::kSmem, stream>>>(
      tx, tw, a, row_tiles, splits, rows_inner, part);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  gmm_split_reduce_kernel<<<dim3(a.R, (a.N + 1023) / 1024), 256, 0, stream>>>(a, splits, part);
  return cudaGetLastError();
}

template <typename T, typename TW, bool TRANS>
cudaError_t launch_gmm(const GmmArgs& a, cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN, (a.R + kBM - 1) / kBM + a.S);
  gmm_kernel<T, TW, TRANS><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_outer(const OuterArgs& a, cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN, (a.K + kBK - 1) / kBK, a.S);
  outer_kernel<<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// grouped_matmul_raw: x [R, K]; w [E, K, N] (trans: [E, N, K]) in x's dtype
// or int8 (w_int8) with scale [E, N] fp32 (nullptr: none); y [R, N]
// zero-filled; starts/lens/wids [S] int32.  dtype 0 fp32, 1 bf16.  route
// (the wrapper's gmm_route): 0 gmm_kernel (fp32 x), 1 gmm_wgmma_kernel (bf16
// x over a bf16 bank), 2 gmm_int8_wgmma_kernel (bf16 x over an int8 bank,
// row tile `rows_tile`, K in `splits` splits, row tiles innermost in the
// grid when `rows_inner`, part: their fp32 scratch [splits, R, N] when
// splits > 1).
int pt_grouped_matmul(const void* x, const void* w, const void* scale, void* y,
                      const void* starts, const void* lens, const void* wids, void* part, int R,
                      int K, int N, int S, int E, int block_rows, int dtype, int w_int8,
                      int trans, int route, int rows_tile, int splits, int rows_inner,
                      void* stream) {
  const GmmArgs a{x, w, static_cast<const float*>(scale), y,
                  static_cast<const int*>(starts), static_cast<const int*>(lens),
                  static_cast<const int*>(wids), R, K, N, S, E, block_rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (route == 1) {
    if (dtype != kBF16 || w_int8 || scale != nullptr) return cudaErrorInvalidValue;
    return trans ? launch_gmm_wgmma<true>(a, st) : launch_gmm_wgmma<false>(a, st);
  }
  if (route == 2) {
    if (dtype != kBF16 || !w_int8 || trans) return cudaErrorInvalidValue;
    switch (rows_tile) {
      case 16: return launch_gmm_int8<16>(a, splits, rows_inner, p, st);
      case 64: return launch_gmm_int8<64>(a, splits, rows_inner, p, st);
      case 128: return launch_gmm_int8<128>(a, splits, rows_inner, p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != 0 || dtype != kF32) return cudaErrorInvalidValue;
  if (w_int8) return trans ? cudaErrorInvalidValue : launch_gmm<float, int8_t, false>(a, st);
  return trans ? launch_gmm<float, float, true>(a, st) : launch_gmm<float, float, false>(a, st);
}

// grouped_outer_raw: x [R, K], dy [R, N] (one dtype); out [S, K, N] fp32,
// every element written.
int pt_grouped_outer(const void* x, const void* dy, void* out, const void* starts,
                     const void* lens, int R, int K, int N, int S, int block_rows, int dtype,
                     void* stream) {
  const OuterArgs a{x, dy, static_cast<float*>(out), static_cast<const int*>(starts),
                    static_cast<const int*>(lens), R, K, N, S, block_rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_outer_wgmma(a, st);
  if (dtype == kF32) return launch_outer(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
