// Batched GEMM with an accumulate-into-output epilogue on the CUDA cores,
// for sm_90a.
//
//   O[z] = A[z] @ B[z]            (C == nullptr)
//   O[z] = C[z] + A[z] @ B[z]     (accumulate)
//
// Replaces src/repro/kernels/gemm.py:_gemm_kernel (the DCA analogue) for
// f32, and for the bf16 shapes the tensor-core kernel (gemm_wgmma.cu)
// cannot address.  Inputs are row-major and contiguous inside each batch
// member; products and sums are taken in f32 and the result is cast to the
// input type, as the reference does.
//
// Bound: FP32 CUDA-core FMAs, 2*M*N*K / 67 TFLOP/s per member on an H100
// SXM (the reference multiplies in f32: TF32 tensor cores would round the
// operands).
//
// Design.  256 threads own one BM x BN output tile (128x128 or 64x64, chosen
// by the wrapper's launch plan so that a small grid still spreads over the
// SMs); each thread keeps a TM x TN register tile (8x8 or 4x4) fed by float4
// reads of the A-transposed and B tiles in shared memory, double-buffered in
// registers (the next k's reads are issued before this k's FMAs).  The K loop runs
// inside the block over 16-deep tiles (in place of the TPU's sequential K
// grid axis and VMEM accumulator) with two shared-memory buffers and a
// register-staged prefetch: the global loads of tile k+1 are issued before
// the FMAs on tile k, stored into the other buffer after them, and one
// __syncthreads() per K step separates the two.  VEC loads A and B as
// 16-byte vectors and stores the output as float4 (f32, K % 4 == N % 4 == 0,
// 16-byte aligned operands); otherwise the same template loads scalars.
// Ragged M, N and K are zero-masked in the loads and masked in the stores;
// blockIdx.z walks the batch, so one launch covers every stacked mesh member.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // A is stored transposed: the pad spreads its stores over the banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements of a row starting at column ``col``, those at
// or past ``cols`` (or the whole quad if ``live`` is false) read as zero.
template <typename T, bool VEC>
__device__ __forceinline__ float4 load_quad(const T* __restrict__ row, int col, int cols,
                                            bool live) {
  if constexpr (VEC) {  // col % 4 == 0 and cols % 4 == 0: the quad is all in or all out
    return (live && col < cols) ? __ldg(reinterpret_cast<const float4*>(row + col))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = (live && col + q < cols) ? to_f32(row[col + q]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, BM * BN >= 128 * 128 ? 2 : 4)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ C, T* __restrict__ O,
            int M, int N, int K,
            long long sA, long long sB, long long sC, long long sO) {
  static_assert(!VEC || sizeof(T) == 4, "16-byte loads are for f32");
  constexpr int TM = BM / 16, TN = BN / 16;       // register tile: 8x8 or 4x4
  constexpr int AQ = BM * BK / 4 / THREADS;       // A quads per thread and tile
  constexpr int BQ = BK * BN / 4 / THREADS;       // B quads per thread and tile
  __shared__ __align__(16) float As[2][BK][BM + PAD];  // A tile, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];

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

  // Thread (ty, tx) owns rows {ty*4 + i + 64h} and columns {tx*4 + j + 64h}:
  // a warp's float4 reads of a B row are then 64 consecutive floats, free of
  // bank conflicts, and its reads of an A-transposed row are broadcasts.
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Tile k's quads into registers: A quad e is row e / 4, k-quad e % 4 (a
  // warp reads 8 rows of 64 bytes); B quad e is k-row e / (BN/4), column
  // quad e % (BN/4) (a warp reads 512 consecutive bytes).
  float4 pa[AQ], pb[BQ];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int l = 0; l < AQ; ++l) {
      const int e = tid + l * THREADS;
      const int r = row0 + e / 4;
      pa[l] = load_quad<T, VEC>(A + (long long)min(r, M - 1) * K, k0 + (e % 4) * 4, K, r < M);
    }
#pragma unroll
    for (int l = 0; l < BQ; ++l) {
      const int e = tid + l * THREADS;
      const int r = k0 + e / (BN / 4);
      pb[l] = load_quad<T, VEC>(B + (long long)min(r, max(K - 1, 0)) * N,
                                col0 + (e % (BN / 4)) * 4, N, r < K);
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int l = 0; l < AQ; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / 4, c = (e % 4) * 4;
      As[buf][c + 0][r] = pa[l].x;
      As[buf][c + 1][r] = pa[l].y;
      As[buf][c + 2][r] = pa[l].z;
      As[buf][c + 3][r] = pa[l].w;
    }
#pragma unroll
    for (int l = 0; l < BQ; ++l) {
      const int e = tid + l * THREADS;
      *reinterpret_cast<float4*>(&Bs[buf][e / (BN / 4)][(e % (BN / 4)) * 4]) = pb[l];
    }
  };

  const int tiles = (K + BK - 1) / BK;
  if (tiles > 0) {
    load_tile(0);
    store_tile(0);
    __syncthreads();
  }
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < tiles;
    if (more) load_tile((t + 1) * BK);  // in flight during the FMAs below

    // Fragments double-buffered in registers: kk + 1's shared-memory reads
    // are issued before kk's FMAs.
    float a[2][TM], b[2][TN];
    auto frag = [&](int kk, int f) {
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][kk][64 * h + ty * 4]);
        a[f][4 * h] = v.x; a[f][4 * h + 1] = v.y; a[f][4 * h + 2] = v.z; a[f][4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 * h + tx * 4]);
        b[f][4 * h] = v.x; b[f][4 * h + 1] = v.y; b[f][4 * h + 2] = v.z; b[f][4 * h + 3] = v.w;
      }
    };
    frag(0, 0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk + 1 < BK) frag(kk + 1, (kk + 1) & 1);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
    }

    // The other buffer was last read in step t - 1, before the barrier that
    // ended it; one barrier then publishes tile t + 1.
    if (more) store_tile(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: add C_in in f32 when accumulating, cast, store what is in range.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + 64 * (i / 4) + ty * 4 + i % 4;
    if (r >= M) continue;
    const long long o0 = (long long)r * N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = col0 + 64 * h + tx * 4;
      float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if constexpr (VEC) {
        if (c >= N) continue;  // N % 4 == 0: the quad is all in or all out
        if (C != nullptr) {
          const float4 cv = __ldg(reinterpret_cast<const float4*>(C + o0 + c));
          v[0] += cv.x; v[1] += cv.y; v[2] += cv.z; v[3] += cv.w;
        }
        *reinterpret_cast<float4*>(O + o0 + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q >= N) continue;
          float x = v[q];
          if (C != nullptr) x += to_f32(C[o0 + c + q]);
          O[o0 + c + q] = from_f32<T>(x);
        }
      }
    }
  }
}

template <typename T, int BM, int BN, bool VEC>
int launch(const void* a, const void* b, const void* c, void* o, int batch,
           int M, int N, int K, long long sA, long long sB, long long sC,
           long long sO, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<T, BM, BN, VEC><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (const T*)c, (T*)o, M, N, K, sA, sB, sC, sO);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int by_tile(int tile, const void* a, const void* b, const void* c, void* o, int batch,
            int M, int N, int K, long long sA, long long sB, long long sC, long long sO,
            void* stream) {
  if (tile == 128)
    return launch<T, 128, 128, VEC>(a, b, c, o, batch, M, N, K, sA, sB, sC, sO, stream);
  if (tile == 64)
    return launch<T, 64, 64, VEC>(a, b, c, o, batch, M, N, K, sA, sB, sC, sO, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ``c`` may be null (no accumulate).
// Strides are element counts between consecutive batch members.  The launch
// plan (kernels/gemm.py:gemm_plan): ``tile`` 128 or 64 (square output
// tiles), ``vector`` 1 for 16-byte loads and stores (f32 only; the caller
// guarantees K % 4 == N % 4 == 0 and 16-byte aligned operands).  Returns the
// cudaError_t of the launch.
extern "C" int repro_gemm(const void* a, const void* b, const void* c, void* o,
                          int dtype, int batch, int M, int N, int K,
                          long long sA, long long sB, long long sC, long long sO,
                          int tile, int vector, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vector)
    return by_tile<float, true>(tile, a, b, c, o, batch, M, N, K, sA, sB, sC, sO, stream);
  if (dtype == 0)
    return by_tile<float, false>(tile, a, b, c, o, batch, M, N, K, sA, sB, sC, sO, stream);
  if (dtype == 1 && !vector)
    return by_tile<__nv_bfloat16, false>(tile, a, b, c, o, batch, M, N, K, sA, sB, sC, sO,
                                         stream);
  return (int)cudaErrorInvalidValue;
}
