// Batched GEMM with an accumulate-into-output epilogue, for sm_90a.
//
//   O[z] = A[z] @ B[z]            (C == nullptr)
//   O[z] = C[z] + A[z] @ B[z]     (accumulate)
//
// Replaces src/repro/kernels/gemm.py:_gemm_kernel (the DCA analogue).
// Inputs are f32 or bf16, row-major and contiguous inside each batch
// member; products and sums are taken in f32 and the result is cast to the
// input type, as the reference does.
//
// Bound: FP32 CUDA-core FMAs (the reference multiplies in f32, so tensor
// cores in TF32 would change the numbers).  Design: one 256-thread block
// per 128x128 output tile; the K loop runs inside the block through 16-deep
// shared-memory tiles (this loop replaces the TPU's sequential K grid
// dimension and its VMEM accumulator); each thread keeps an 8x8 register
// micro-tile, so every value read from shared memory feeds 8 FMAs.  Ragged
// M, N and K are masked in the loads and the stores.  blockIdx.z walks the
// batch, so one launch covers every member of a stacked mesh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps the transposed A stores off one bank

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ C, T* __restrict__ O,
            int M, int N, int K,
            long long sA, long long sB, long long sC, long long sO) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // A tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  A += z * sA;
  B += z * sB;
  O += z * sO;
  if (C != nullptr) C += z * sC;

  // Thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
  // {tx*4 + j, 64 + tx*4 + j}: a warp's float4 reads of a B row are then
  // 64 consecutive floats, free of bank conflicts.
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK): consecutive threads read consecutive k of a row.
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f32(A[(long long)gr * K + gc]) : 0.f;
    }
    // B tile (BK x BN): consecutive threads read consecutive columns.
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f32(B[(long long)gr * N + gc]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: add C_in in f32 when accumulating, cast, store what is in range.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c >= N) continue;
      const long long o = (long long)r * N + c;
      float v = acc[i][j];
      if (C != nullptr) v += to_f32(C[o]);
      O[o] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c, void* o, int batch,
           int M, int N, int K, long long sA, long long sB, long long sC,
           long long sO, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (T*)o, M, N, K, sA, sB, sC, sO);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ``c`` may be null (no accumulate).
// Strides are element counts between consecutive batch members.
// Returns the cudaError_t of the launch.
extern "C" int repro_gemm(const void* a, const void* b, const void* c, void* o,
                          int dtype, int batch, int M, int N, int K,
                          long long sA, long long sB, long long sC, long long sO,
                          void* stream) {
  if (dtype == 0)
    return launch<float>(a, b, c, o, batch, M, N, K, sA, sB, sC, sO, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, c, o, batch, M, N, K, sA, sB, sC, sO, stream);
  return (int)cudaErrorInvalidValue;
}
