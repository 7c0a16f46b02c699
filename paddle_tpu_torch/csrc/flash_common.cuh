// Pieces shared by the flash-attention kernels of csrc/flash_attention.cu
// (head-batched, B1/B2) and csrc/masked_flash_attention.cu (masked, B5/B6):
// the CTA shape, the dtype helpers, warp reductions and the tile products
// between shared-memory operands (tensor cores for bf16, CUDA cores for
// fp32).  Everything sits in an anonymous namespace: each source that
// includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // elements added to every shared-memory row (bank spread)
constexpr size_t kSmemLimit = 232448;  // 227 KB a block may opt into

enum DTypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// Products between shared-memory tiles, every warp of the CTA taking part.
// A, B hold T; C is fp32.  Row-major with leading dimensions lda/ldb/ldc.
//   abt:     C  = A[M,K] * B[N,K]^T
//   ab_acc:  C += A[M,K] * B[K,N]
//   atb_acc: C += A[K,M]^T * B[K,N]
// The generic version is the fp32 CUDA-core path: one thread per element of C.
template <typename T>
struct Mma {
  __device__ static void abt(float* C, int ldc, const T* A, int lda, const T* B, int ldb,
                             int M, int N, int K) {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N, n = idx % N;
      const T* a = A + m * lda;
      const T* b = B + n * ldb;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc += to_f(a[k]) * to_f(b[k]);
      C[m * ldc + n] = acc;
    }
  }
  __device__ static void ab_acc(float* C, int ldc, const T* A, int lda, const T* B, int ldb,
                                int M, int N, int K) {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N, n = idx % N;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc += to_f(A[m * lda + k]) * to_f(B[k * ldb + n]);
      C[m * ldc + n] += acc;
    }
  }
  __device__ static void atb_acc(float* C, int ldc, const T* A, int lda, const T* B, int ldb,
                                 int M, int N, int K) {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N, n = idx % N;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc += to_f(A[k * lda + m]) * to_f(B[k * ldb + n]);
      C[m * ldc + n] += acc;
    }
  }
};

// bf16: tensor cores, one 16x16 output tile per warp at a time, fp32
// accumulation.  M, N and K are multiples of 16 (the host picks the tiles).
template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  __device__ static void abt(float* C, int ldc, const T* A, int lda, const T* B, int ldb,
                             int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int tn = N / 16;
    for (int t = warp; t < (M / 16) * tn; t += kWarps) {
      const int i = t / tn, j = t % tn;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
      Acc c;
      wmma::fill_fragment(c, 0.f);
      for (int k = 0; k < K; k += 16) {
        wmma::load_matrix_sync(a, A + i * 16 * lda + k, lda);
        wmma::load_matrix_sync(b, B + j * 16 * ldb + k, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i * 16 * ldc + j * 16, c, ldc, wmma::mem_row_major);
    }
  }
  __device__ static void ab_acc(float* C, int ldc, const T* A, int lda, const T* B, int ldb,
                                int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int tn = N / 16;
    for (int t = warp; t < (M / 16) * tn; t += kWarps) {
      const int i = t / tn, j = t % tn;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
      Acc c;
      float* cp = C + i * 16 * ldc + j * 16;
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      for (int k = 0; k < K; k += 16) {
        wmma::load_matrix_sync(a, A + i * 16 * lda + k, lda);
        wmma::load_matrix_sync(b, B + k * ldb + j * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  }
  __device__ static void atb_acc(float* C, int ldc, const T* A, int lda, const T* B, int ldb,
                                 int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int tn = N / 16;
    for (int t = warp; t < (M / 16) * tn; t += kWarps) {
      const int i = t / tn, j = t % tn;
      // A^T read column-major straight from A's row-major storage
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
      Acc c;
      float* cp = C + i * 16 * ldc + j * 16;
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      for (int k = 0; k < K; k += 16) {
        wmma::load_matrix_sync(a, A + k * lda + i * 16, lda);
        wmma::load_matrix_sync(b, B + k * ldb + j * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  }
};

}  // namespace
