// N-way elementwise reduction, for sm_90a: x viewed as (outer, n, inner)
// -> out (outer, inner), reducing the middle dimension.
//
// Replaces src/repro/kernels/reduce_nway.py:_reduce_kernel (the parallel
// reduction router).  Ops, as in the reference:
//   add  sums in f32 and casts back (f32, bf16 and int32 inputs);
//   max  elementwise maximum, NaN-propagating (f32, bf16);
//   and  bitwise AND over int32 rows (the LsbAnd barrier).
//
// Bound: device-memory bytes, (n + 1) * outer * inner * itemsize.  Design:
// each thread owns VEC consecutive elements of one output row (16 bytes,
// where the row length and both pointers allow it), reads them from every
// one of the n input rows with one vector load each, and keeps the running
// value in registers.  Neighbouring threads touch neighbouring 16-byte
// words, so every load is coalesced; nothing is staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int THREADS = 256;
enum Op { ADD = 0, MAX = 1, AND = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ int from_f32<int>(float x) { return __float2int_rz(x); }

// The running value: f32 for add and max, the integer itself for and.
template <typename T, int OP> struct Acc { using type = float; };
template <> struct Acc<int, AND> { using type = int; };

template <typename T, int OP>
__device__ __forceinline__ typename Acc<T, OP>::type load_acc(T x) {
  if constexpr (OP == AND) return x; else return to_f32(x);
}

template <typename T, int OP>
__device__ __forceinline__ void combine(typename Acc<T, OP>::type& acc, T x) {
  if constexpr (OP == ADD) {
    acc += to_f32(x);
  } else if constexpr (OP == MAX) {
    const float v = to_f32(x);
    acc = (v > acc || v != v) ? v : acc;
  } else {
    acc &= x;
  }
}

template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const T* __restrict__ x, T* __restrict__ out, long long outer,
              int n, long long inner) {
  using A = typename Acc<T, OP>::type;
  using V = Vec<T, VEC>;
  const long long slots = inner / VEC;
  const long long total = outer * slots;
  for (long long s = (long long)blockIdx.x * THREADS + threadIdx.x; s < total;
       s += (long long)gridDim.x * THREADS) {
    const long long o = s / slots;
    const long long e = (s - o * slots) * VEC;
    const T* p = x + o * n * inner + e;
    A acc[VEC];
    V v = *reinterpret_cast<const V*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = load_acc<T, OP>(v.v[j]);
    for (int i = 1; i < n; ++i) {
      v = *reinterpret_cast<const V*>(p + i * inner);
#pragma unroll
      for (int j = 0; j < VEC; ++j) combine<T, OP>(acc[j], v.v[j]);
    }
    V r;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (OP == AND) r.v[j] = acc[j]; else r.v[j] = from_f32<T>(acc[j]);
    }
    *reinterpret_cast<V*>(out + o * inner + e) = r;
  }
}

template <typename T, int OP>
int launch(const void* x, void* out, long long outer, int n, long long inner,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = inner % V == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long slots = outer * (vec ? inner / V : inner);
  if (slots == 0) return 0;
  long long blocks = (slots + THREADS - 1) / THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  if (vec)
    reduce_kernel<T, OP, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const T*)x, (T*)out, outer, n, inner);
  else
    reduce_kernel<T, OP, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const T*)x, (T*)out, outer, n, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int32.  op: 0 = add, 1 = max, 2 = and.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// dtype/op pair the reference does not define).
extern "C" int repro_reduce_nway(const void* x, void* out, int dtype, int op,
                                 long long outer, int n, long long inner,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && op == ADD) return launch<float, ADD>(x, out, outer, n, inner, s);
  if (dtype == 0 && op == MAX) return launch<float, MAX>(x, out, outer, n, inner, s);
  if (dtype == 1 && op == ADD) return launch<__nv_bfloat16, ADD>(x, out, outer, n, inner, s);
  if (dtype == 1 && op == MAX) return launch<__nv_bfloat16, MAX>(x, out, outer, n, inner, s);
  if (dtype == 2 && op == ADD) return launch<int, ADD>(x, out, outer, n, inner, s);
  if (dtype == 2 && op == AND) return launch<int, AND>(x, out, outer, n, inner, s);
  return (int)cudaErrorInvalidValue;
}
