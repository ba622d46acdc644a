// RG-LRU linear recurrence, for sm_90a.
//
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w],   h[b, -1, w] = 0
//
// a, b, h are (B, S, W), contiguous, f32 or bf16; the recurrence runs in f32
// and h is written in a's type.
//
// Replaces src/repro/kernels/rglru.py:rglru_scan (_rglru_kernel): the same
// function, with the boundary state carried from one chunk of time to the
// next in f32.
//
// Bound: bytes.  a and b are read once and h written once, 3 * B * S * W
// elements, against 2 * B * S * W flops.
//
// Design.  The TPU kernel walks chunks of 128 steps as a sequential grid
// axis and carries the boundary state in VMEM.  Here one block of 32 x 16
// threads owns 32 consecutive channels of one batch row and loops over
// chunks of 128 steps inside the block: lane x is channel x (a warp's loads
// are 32 neighbouring values of one step, coalesced), and row y scans the
// chunk's steps 8y..8y+7 from registers, keeping the running product of a
// and its local h.  The 16 rows' (prod a, h) pairs meet in shared memory;
// row y folds rows 0..y-1 into the chunk's incoming state to get its own,
// adds prod(a) * h_in to each of its 8 steps, and every row folds all 16 to
// carry the state into the next chunk (the same operations in the same
// order, so every row holds the same carry).  One thread per channel over
// all of S would give B * W threads (10,240 at the serving shape): too few
// to keep enough loads in flight on 132 SMs; this gives 16 times as many.
// Steps past S and channels past W read a = 1, b = 0 and write nothing, so
// S and W need not be multiples of anything: the TPU's S % chunk assert is
// not kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;  // channels per block
constexpr int ROWS = 16;   // time segments per chunk
constexpr int STEPS = 8;   // steps per segment
constexpr int CHUNK = ROWS * STEPS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(LANES * ROWS)
rglru_kernel(const T* __restrict__ A, const T* __restrict__ Bv, T* __restrict__ H, int S,
             int W) {
  __shared__ float seg_a[ROWS][LANES + 1];
  __shared__ float seg_h[ROWS][LANES + 1];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int c = blockIdx.x * LANES + lane;
  const bool live_c = c < W;
  const long long base = (long long)blockIdx.y * S * W + c;

  float carry = 0.f;  // the state entering the chunk
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int tb = t0 + row * STEPS;
    float av[STEPS], bv[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = tb + j;
      const bool live = live_c && t < S;
      av[j] = live ? to_f32(A[base + (long long)t * W]) : 1.f;
      bv[j] = live ? to_f32(Bv[base + (long long)t * W]) : 0.f;
    }
    // Local scan of this segment from h = 0: bv becomes the local h, av the
    // running product of a.
    float h = 0.f, p = 1.f;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      h = fmaf(av[j], h, bv[j]);
      p *= av[j];
      bv[j] = h;
      av[j] = p;
    }
    seg_a[row][lane] = p;
    seg_h[row][lane] = h;
    __syncthreads();
    float h_in = carry;
    for (int r = 0; r < row; ++r) h_in = fmaf(seg_a[r][lane], h_in, seg_h[r][lane]);
    float next = h_in;
    for (int r = row; r < ROWS; ++r) next = fmaf(seg_a[r][lane], next, seg_h[r][lane]);
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = tb + j;
      if (live_c && t < S) H[base + (long long)t * W] = from_f32<T>(fmaf(av[j], h_in, bv[j]));
    }
    carry = next;
    __syncthreads();  // seg_a / seg_h are read before the next chunk writes them
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W, void* stream) {
  const dim3 grid((W + LANES - 1) / LANES, B);
  if (B > 65535) return (int)cudaErrorInvalidValue;
  rglru_kernel<T><<<grid, dim3(LANES, ROWS), 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (T*)h, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a, b, h: (B, S, W) contiguous, all of
// one type.  Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan(const void* a, const void* b, void* h, int dtype, int B,
                                int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  if (dtype == 0) return launch<float>(a, b, h, B, S, W, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, B, S, W, stream);
  return (int)cudaErrorInvalidValue;
}
