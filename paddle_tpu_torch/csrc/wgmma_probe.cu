// One-tile probe of the shared-memory layouts in hopper.cuh: a single
// warpgroup loads its operands with TMA (128-byte swizzle, 64-column panels)
// and runs the wgmma forms the kernels use, so a wrong descriptor shows as
// a wrong product at one tile, against torch.matmul
// (tests/test_torch_cuda_kernels.py::test_wgmma_probe_matches_matmul).
//
// Modes, a and b bf16 row-major, c fp32 row-major:
//   0  c[64, 64]  = a[64, 64] @ b[64, 64]^T    A, B K-major from shared memory
//                                              (B1's S = Q K^T)
//   1  c[64, 128] = a[64, 64] @ b[64, 128]     A from registers, B MN-major,
//                                              one n64 product per panel (B1's O += P V)
//   2  c[64, 256] = a[64, 64]^T @ b[64, 256]   A and B MN-major, B 256 wide
//                                              over four panels (B8's x^T dy)
//   3  c[64, 256] = a[64, 64] @ b[64, 256]     A K-major, B MN-major over four
//                                              panels (B7's forward x w)
//   4  c[64, 256] = a[64, 64] @ b[256, 64]^T   A K-major, B K-major, one panel
//                                              of 256 rows (B7's dx dy w^T)
//   5  c[64, 128] = a[64, 64] @ b[64, 128]     A from registers, B MN-major over
//                                              two panels as one n128 product
//                                              (B2's dq, dk and dv at d 128)
//   6  c[64, 64]  = a[64, 64]^T @ b[64, 64]    A and B MN-major, n64, A stored by
//                                              the threads through swizzle128
//                                              (B6's fused dq = ds K from ds^T)
//   7, 8, 9  c[128, NR] = q[64, 128]^T @ b[NR, 64]^T for NR 16, 64, 128: q
//            int8 loaded through an 8-bit tensor map (128-byte swizzle),
//            widened to bf16 by widen_i8_panel into two swizzled panels (A,
//            MN-major), b K-major; wgmma m64nNRk16, two per k step (B7
//            int8's swapped product, gmm_int8_wgmma_kernel)

#include "hopper.cuh"

namespace {

constexpr int kPanelBytes = 64 * 128;  // [64 rows][64] bf16

__device__ __forceinline__ void store_acc(float* c, int ldc, int col0, const float* acc, int n) {
  const int t = threadIdx.x, lane = t % 32;
  for (int i = 0; i < n; i += 2) {
    const int row = (t / 32) * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int col = col0 + (i / 4) * 8 + (lane % 4) * 2;
    c[row * ldc + col] = acc[i];
    c[row * ldc + col + 1] = acc[i + 1];
  }
}

// modes 7-9: the B7 int8 form at row tile NR (one warpgroup takes both
// 64-column halves of the int8 tile)
template <int NR>
__global__ void __launch_bounds__(128) wgmma_int8_probe_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tb, float* c) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* q_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;  // [64][128] int8
  unsigned char* b_s = q_s + 64 * 128;                                        // [NR][64] bf16
  unsigned char* panels = b_s + NR * 128;                                     // 2 x [64][64] bf16
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, 64 * 128 + NR * 128);
    tma_load_2d(q_s, &tq, &bar, 0, 0);
    tma_load_2d(b_s, &tb, &bar, 0, 0);
  }
  mbar_wait(&bar, 0);
  for (int h = 0; h < 2; ++h) widen_i8_panel(q_s, panels + h * kPanelBytes, h, threadIdx.x);
  fence_proxy_async();
  __syncthreads();
  float acc[2][NR / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[h][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wgmma_ss<NR, 1, 0>(acc[h], smem_desc(panels + h * kPanelBytes + ks * 16 * 128, kPanelBytes, 1024),
                         smem_desc(b_s + ks * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    fence_regs(acc[h]);
    store_acc(c + h * 64 * NR, NR, 0, acc[h], NR / 2);
  }
}

template <int NR>
cudaError_t launch_int8_probe(const void* a, const void* b, float* c, cudaStream_t stream) {
  const uint64_t qd[2] = {128, 64}, qs[1] = {128};
  const uint32_t qb[2] = {128, 64};
  const uint64_t bd[2] = {64, NR}, bs[1] = {128};
  const uint32_t bb[2] = {64, NR};
  CUtensorMap tq, tb;
  cudaError_t e = encode_u8_map(&tq, a, 2, qd, qs, qb);
  if (e == cudaSuccess) e = encode_bf16_map(&tb, b, 2, bd, bs, bb);
  if (e != cudaSuccess) return e;
  const int smem = 64 * 128 + NR * 128 + 2 * kPanelBytes + 1024;
  e = cudaFuncSetAttribute(wgmma_int8_probe_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  wgmma_int8_probe_kernel<NR><<<1, 128, smem, stream>>>(tq, tb, c);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(128) wgmma_probe_kernel(const __grid_constant__ CUtensorMap ta,
                                                          const __grid_constant__ CUtensorMap tb,
                                                          const __nv_bfloat16* a, float* c,
                                                          int mode) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* a_s = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* b_s = a_s + kPanelBytes;
  const int b_panels = (mode == 0 || mode == 6) ? 1 : (mode == 1 || mode == 5) ? 2 : 4;
  const bool a_by_threads = mode == 6;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&bar, ((a_by_threads ? 0 : 1) + b_panels) * kPanelBytes);
    if (!a_by_threads) tma_load_2d(a_s, &ta, &bar, 0, 0);
    // b's panels lie along its columns, or (mode 4) along its rows
    for (int p = 0; p < b_panels; ++p)
      tma_load_2d(b_s + p * kPanelBytes, &tb, &bar, mode == 4 ? 0 : 64 * p, mode == 4 ? 64 * p : 0);
  }
  if (a_by_threads) {
    // a's rows (the k index) as 128-byte rows of 32 bf16 pairs, swizzled
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
    for (int i = threadIdx.x; i < 64 * 32; i += 128)
      *reinterpret_cast<uint32_t*>(a_s + swizzle128(i / 32, (i % 32) * 4)) = a32[i];
    fence_proxy_async();
    __syncthreads();
  }
  mbar_wait(&bar, 0);

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  // the register fragment of a: rows w*16 + lane/4 (+8), k columns ks*16 + ...
  auto fragment = [&](int ks, uint32_t (&af)[4]) {
    const int r = w * 16 + lane / 4, k = ks * 16 + (lane % 4) * 2;
    auto pair = [&](int row, int col) {
      return pack_bf16(__bfloat162float(a[row * 64 + col]), __bfloat162float(a[row * 64 + col + 1]));
    };
    af[0] = pair(r, k);
    af[1] = pair(r + 8, k);
    af[2] = pair(r, k + 8);
    af[3] = pair(r + 8, k + 8);
  };
  if (mode == 3 || mode == 4) {
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = smem_desc(a_s + ks * 32, 16, 1024);
      if (mode == 3)
        wgmma_ss_n256<0, 1>(acc, da, smem_desc(b_s + ks * 16 * 128, kPanelBytes, 1024), 1);
      else
        wgmma_ss_n256<0, 0>(acc, da, smem_desc(b_s + ks * 32, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc(c, 256, 0, acc, 128);
    return;
  }
  if (mode == 5) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4];
      fragment(ks, af);
      wgmma_rs_n128<1>(acc, af, smem_desc(b_s + ks * 16 * 128, kPanelBytes, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc(c, 128, 0, acc, 64);
    return;
  }
  if (mode == 6) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<1, 1>(acc, smem_desc(a_s + ks * 16 * 128, kPanelBytes, 1024),
                         smem_desc(b_s + ks * 16 * 128, kPanelBytes, 1024), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc(c, 64, 0, acc, 32);
  } else if (mode == 0) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(acc, smem_desc(a_s + ks * 32, 16, 1024),
                         smem_desc(b_s + ks * 32, 16, 1024), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc(c, 64, 0, acc, 32);
  } else if (mode == 1) {
    float acc[2][32];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[4];
      fragment(ks, af);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        wgmma_rs_n64<1>(acc[p], af, smem_desc(b_s + p * kPanelBytes + ks * 16 * 128,
                                              kPanelBytes, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      fence_regs(acc[p]);
      store_acc(c, 128, 64 * p, acc[p], 32);
    }
  } else {
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n256<1, 1>(acc, smem_desc(a_s + ks * 16 * 128, kPanelBytes, 1024),
                          smem_desc(b_s + ks * 16 * 128, kPanelBytes, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc(c, 256, 0, acc, 128);
  }
}

}  // namespace

extern "C" {

// a [64, 64] bf16; b [64, 64] (modes 0, 6), [64, 128] (1, 5), [64, 256] (2,
// 3), [256, 64] (4) bf16; c fp32 as the mode says.  Modes 7, 8, 9: a
// [64, 128] int8, b [NR, 64] bf16 for NR 16, 64, 128, c [128, NR].
int pt_wgmma_probe(int mode, const void* a, const void* b, void* c, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(c);
  if (mode == 7) return launch_int8_probe<16>(a, b, cf, st);
  if (mode == 8) return launch_int8_probe<64>(a, b, cf, st);
  if (mode == 9) return launch_int8_probe<128>(a, b, cf, st);
  if (mode < 0 || mode > 6) return cudaErrorInvalidValue;
  const uint64_t bw = mode == 0 || mode == 4 || mode == 6 ? 64
                      : mode == 1 || mode == 5         ? 128
                                                       : 256;
  const uint64_t bh = mode == 4 ? 256 : 64;
  const uint64_t ad[2] = {64, 64}, as[1] = {128};
  const uint64_t bd[2] = {bw, bh}, bs[1] = {2 * bw};
  const uint32_t box[2] = {64, 64};
  CUtensorMap ta, tb;
  cudaError_t e = encode_bf16_map(&ta, a, 2, ad, as, box);
  if (e == cudaSuccess) e = encode_bf16_map(&tb, b, 2, bd, bs, box);
  if (e != cudaSuccess) return e;
  const int smem = 5 * kPanelBytes + 1024;
  e = cudaFuncSetAttribute(wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wgmma_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(c), mode);
  return cudaGetLastError();
}

}  // extern "C"
