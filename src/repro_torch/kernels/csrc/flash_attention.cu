// Causal (optionally sliding-window) flash attention, forward, for sm_90a.
//
//   O[b] = softmax(mask((q[b] * scale) @ k[b]^T)) @ v[b],   scale = 1/sqrt(D)
//
// keeping key j for query i iff j <= i, and also j > i - window when
// window > 0.  q, k, v, O are (BH, S, D), contiguous, f32 or bf16; every
// product and sum is taken in f32 and the output is cast to q's type.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel): the same online softmax with f32 running max m,
// normaliser l and accumulator, masked logits at -2e38, and the output
// acc / max(l, 1e-30).
//
// Bound: operations, 4*D multiply-adds per live (query, key) pair on the
// f32 CUDA cores (bf16 * bf16 is exact in f32, so the f32 result matches
// the reference's f32 products); q, k, v and O are read and written once.
//
// Design.  The TPU kernel walks the kv tiles as a sequential grid axis and
// carries m/l/acc in VMEM from one grid step to the next.  Here one block
// of 256 threads owns a tile of BQ = 64 queries and loops over the kv
// tiles inside the block: K (transposed) and then V go through one shared
// buffer, the 64x64 probabilities through another, and m/l/acc stay in
// registers.  Thread (ty, tx) of a 16x16 grid holds queries ty*4..ty*4+3:
// for the logits it computes keys tx*4..tx*4+3 (a 4x4 register tile fed by
// two float4 reads per depth step), and for the output it accumulates
// columns tx + 16*n.  A row's max and sum are reduced over the 16 threads
// that share it with warp shuffles.  Only the kv tiles that hold a live key
// for some query of the tile are visited (the TPU kernel's pl.when skip),
// so a sliding-window layer costs O(S * window).  The last tiles of q and
// kv may be ragged: rows past S are zero-filled and masked, so S need not
// be a multiple of any tile.  Blocks are numbered so that the q tiles with
// the most kv tiles (the last ones, under the causal mask) start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps rows 16-byte aligned and spreads transposed stores
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Max and sum over the 16 lanes that share a query row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Qt [D][BQ+PAD] + KV [D][BKV+PAD] (K transposed, then V as [BKV][D]) + Pt [BKV][BQ+PAD]
  return sizeof(float) * ((size_t)D * (BQ + PAD) + (size_t)D * (BKV + PAD) +
                          (size_t)BKV * (BQ + PAD));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
             T* __restrict__ O, int BH, int S, int window, float scale) {
  static_assert(D % 16 == 0 && D >= 16, "D must be a multiple of 16");
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [D][BQ + PAD]
  float* KV = Qt + D * (BQ + PAD);        // [D][BKV + PAD] as Kt, or [BKV][D] as V
  float* Pt = KV + D * (BKV + PAD);       // [BKV][BQ + PAD]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int qi = nq - 1 - blockIdx.x / BH;  // longest causal rows first
  const int q0 = qi * BQ;
  const long long base = (long long)bh * S * D;
  Q += base;
  K += base;
  V += base;
  O += base;

  // Q tile, scaled as the reference scales it, transposed: Qt[c][r].
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int gr = q0 + r;
    Qt[c * (BQ + PAD) + r] = gr < S ? to_f32(Q[(long long)gr * D + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  // The kv tiles that hold a live key for some query of this tile.
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int kt_hi = q_last / BKV;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BKV : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's V and P are no longer read
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int gr = k0 + r;
      KV[c * (BKV + PAD) + r] = gr < S ? to_f32(K[(long long)gr * D + c]) : 0.f;
    }
    __syncthreads();

    // s = (q * scale) k^T for queries ty*4+i and keys tx*4+j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[c * (BQ + PAD) + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&KV[c * (BKV + PAD) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Mask, then the online-softmax update of m, l and acc.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        live[j] = kp <= qp && kp < S && (window <= 0 || kp > qp - window);
        if (!live[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        Pt[(tx * 4 + j) * (BQ + PAD) + ty * 4 + i] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();  // every thread is done with Kt, and P is complete

    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int gr = k0 + r;
      KV[r * D + c] = gr < S ? to_f32(V[(long long)gr * D + c]) : 0.f;
    }
    __syncthreads();

    // acc += P @ V for queries ty*4+i and columns tx + 16*n.
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[j * (BQ + PAD) + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float vv = KV[j * D + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      O[(long long)r * D + tx + 16 * n] = from_f32<T>(acc[i][n] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int window, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));  // as the reference rounds it
  flash_kernel<T, D><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, BH, S, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
             int window, void* stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, S, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, S, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, BH, S, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o: (BH, S, D) contiguous;
// D in {16, 32, 64, 128, 256}; window <= 0 means plain causal.
// Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int dtype, int BH, int S, int D, int window,
                                     void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (dtype == 0) return dispatch<float>(q, k, v, o, BH, S, D, window, stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, BH, S, D, window, stream);
  return (int)cudaErrorInvalidValue;
}
