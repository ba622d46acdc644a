// N-way elementwise reduction, for sm_90a: x viewed as (outer, n, inner)
// through two strides -> out (outer, inner), contiguous, reducing the middle
// dimension.
//
// Replaces src/repro/kernels/reduce_nway.py:_reduce_kernel (the parallel
// reduction router).  Ops, as in the reference:
//   add  sums in f32, in member order, and casts back once (f32, bf16 and
//        int32 inputs);
//   max  elementwise maximum, NaN-propagating (f32, bf16); exact on int32,
//        whose running value stays an int32 (f32 would round above 2^24);
//   and  bitwise AND over int32 rows (the LsbAnd barrier).
//
// Layout: element (o, i, e) of x lies at o * so + i * sn + e (so may be 0,
// an expand over the dims before the reduced one); the dims after the
// reduced one form one contiguous run of `inner` elements.
//
// Bound: device-memory bytes, each input row read once and the output
// written once, over 3.35 TB/s.  Design: each thread owns one vector of
// one output row (16 bytes where the plan allows it, else one element) and
// each block a tile of THREADS vectors, so that the card's block scheduler
// balances the SMs; neighbouring blocks take the same columns of
// neighbouring rows.  The tile's row and offset come from one 32-bit
// division a block and 64-bit pointers, so one path serves inputs of any
// size.  A thread walks the n rows 4 at a time and issues a group's loads
// (predicated past n) before the group's first combine.  n = 1 and n = 2
// (the rank mesh at world size 1, the data axis) have kernels of their
// own with the rows written out, which on the card read 20-25 % and 9 %
// faster than the loop; at n = 4, 8 and 16 an unrolled n gained nothing
// (PERF.md section 6).  The running
// values stay in registers; nothing is staged in shared memory; a 16-byte
// vector is one 128-bit load or store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
enum Op { ADD = 0, MAX = 1, AND = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// A 16-byte vector moves as one int4, so that a load or a store is one
// 128-bit LDG or STG whatever the element type and whatever predicate
// guards it.
template <typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (sizeof(V) == 16) {
    const int4 r = *reinterpret_cast<const int4*>(p);
    V v;
    memcpy(&v, &r, 16);
    return v;
  } else {
    return *p;
  }
}

template <typename V>
__device__ __forceinline__ void store(V* p, const V& v) {
  if constexpr (sizeof(V) == 16) {
    int4 r;
    memcpy(&r, &v, 16);
    *reinterpret_cast<int4*>(p) = r;
  } else {
    *p = v;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ int from_f32<int>(float x) { return __float2int_rz(x); }

// The running value: f32 for add and for float max, the integer itself for
// and and for int32 max.
template <typename T, int OP> struct Acc { using type = float; };
template <> struct Acc<int, AND> { using type = int; };
template <> struct Acc<int, MAX> { using type = int; };

template <typename T, int OP, int VEC>
__device__ __forceinline__ void start(typename Acc<T, OP>::type (&acc)[VEC],
                                      const Vec<T, VEC>& x) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if constexpr (std::is_same_v<typename Acc<T, OP>::type, T>) acc[j] = x.v[j];
    else acc[j] = to_f32(x.v[j]);
  }
}

template <typename T, int OP, int VEC>
__device__ __forceinline__ void combine(typename Acc<T, OP>::type (&acc)[VEC],
                                        const Vec<T, VEC>& x) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if constexpr (OP == ADD) {
      acc[j] += to_f32(x.v[j]);
    } else if constexpr (OP == MAX && std::is_same_v<T, int>) {
      acc[j] = max(acc[j], x.v[j]);
    } else if constexpr (OP == MAX) {
      const float v = to_f32(x.v[j]);
      acc[j] = (v > acc[j] || v != v) ? v : acc[j];
    } else {
      acc[j] &= x.v[j];
    }
  }
}

// One block a tile of THREADS vectors of one output row; at most 128
// registers a thread, so that two blocks fit on an SM.  ROWS > 0: exactly
// ROWS rows, written out; ROWS == 0: n rows, 4 at a time.
template <typename T, int OP, int ROWS, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
reduce_kernel(const T* __restrict__ x, T* __restrict__ out, long long so, long long sn,
              long long inner, int n, unsigned outer) {
  using A = typename Acc<T, OP>::type;
  using V = Vec<T, VEC>;
  // Neighbouring blocks take the same columns of neighbouring rows (so
  // that an expand, so = 0, reads each byte from L2 the second time).
  const unsigned t = blockIdx.x / outer;
  const unsigned o = blockIdx.x - t * outer;
  const long long e = ((long long)t * THREADS + threadIdx.x) * VEC;  // this thread's vector
  if (e >= inner) return;  // inner is a multiple of VEC
  const T* src = x + o * so + e;
  auto row = [&](int i) { return load(reinterpret_cast<const V*>(src + i * sn)); };
  A acc[VEC];
  if constexpr (ROWS > 0) {
    V v[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) v[i] = row(i);
    start<T, OP>(acc, v[0]);
#pragma unroll
    for (int i = 1; i < ROWS; ++i) combine<T, OP>(acc, v[i]);
  } else {
    for (int i = 0; i < n; i += 4) {
      V v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i + r < n) v[r] = row(i + r);
      if (i == 0) start<T, OP>(acc, v[0]);
      else combine<T, OP>(acc, v[0]);
#pragma unroll
      for (int r = 1; r < 4; ++r)
        if (i + r < n) combine<T, OP>(acc, v[r]);
    }
  }
  V r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if constexpr (std::is_same_v<A, T>) r.v[j] = acc[j];
    else r.v[j] = from_f32<T>(acc[j]);
  }
  store(reinterpret_cast<V*>(out + o * inner + e), r);
}

template <typename T, int OP>
int launch(const void* x, void* out, long long outer, int n, long long inner, long long so,
           long long sn, int vec, int blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec != 1 && vec != V) return (int)cudaErrorInvalidValue;
  if (vec > 1 && ((uintptr_t)x % 16 || (uintptr_t)out % 16 || inner % vec || so % vec ||
                  sn % vec))
    return (int)cudaErrorMisalignedAddress;
  if (blocks == 0) return 0;
  using Kernel = void (*)(const T*, T*, long long, long long, long long, int, unsigned);
  Kernel kernel = reduce_kernel<T, OP, 0, V>;
  if (vec == 1) kernel = reduce_kernel<T, OP, 0, 1>;
  else if (n == 1) kernel = reduce_kernel<T, OP, 1, V>;
  else if (n == 2) kernel = reduce_kernel<T, OP, 2, V>;
  kernel<<<blocks, THREADS, 0, stream>>>((const T*)x, (T*)out, so, sn, inner, n,
                                         (unsigned)outer);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int32.  op: 0 = add, 1 = max, 2 = and.
// so, sn: strides in elements of the collapsed dims before the reduced one
// and of the reduced one.  vec, blocks: the wrapper's launch plan
// (reduce_nway.py:reduce_plan), taken as given: elements a vector (16
// bytes or 1), the grid (outer times a row's tiles of 256 vectors).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// dtype/op pair the reference does not define or a vector width the kernel
// was not built for, cudaErrorMisalignedAddress for a 16-byte plan on a
// layout that is not 16-byte aligned).
extern "C" int repro_reduce_nway(const void* x, void* out, int dtype, int op,
                                 long long outer, int n, long long inner, long long so,
                                 long long sn, int vec, int blocks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaErrorInvalidValue;
#define REDUCE(T, OP) launch<T, OP>(x, out, outer, n, inner, so, sn, vec, blocks, s)
  if (dtype == 0 && op == ADD) return REDUCE(float, ADD);
  if (dtype == 0 && op == MAX) return REDUCE(float, MAX);
  if (dtype == 1 && op == ADD) return REDUCE(__nv_bfloat16, ADD);
  if (dtype == 1 && op == MAX) return REDUCE(__nv_bfloat16, MAX);
  if (dtype == 2 && op == ADD) return REDUCE(int, ADD);
  if (dtype == 2 && op == MAX) return REDUCE(int, MAX);
  if (dtype == 2 && op == AND) return REDUCE(int, AND);
#undef REDUCE
  return (int)cudaErrorInvalidValue;
}
