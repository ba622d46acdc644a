// Causal (optionally sliding-window) flash attention, forward, for sm_90a,
// on warp-level tensor cores (mma.sync) with f32 accuracy by 3xTF32.
//
//   O[b] = softmax(mask((q[b] * scale) @ k[b]^T)) @ v[b],   scale = 1/sqrt(D)
//
// keeping key j for query i iff j <= i, and also j > i - window when
// window > 0.  q, k, v, O are (BH, S, D), contiguous and 16-byte aligned,
// f32 or bf16; the output is cast to q's type.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel): the same online softmax with f32 running max m,
// normaliser l and accumulator, masked logits at -2e38, and the output
// acc / max(l, 1e-30).
//
// Bound: operations.  The reference multiplies in f32.  TF32 keeps 10 of
// f32's 23 mantissa bits, so one TF32 product rounds V's rows by up to
// 2^-11 relative, five times the f32 limit this kernel is held to.  Each
// f32 operand x is split once into hi = x with its low 13 bits cleared
// (exact in TF32) and lo = x - hi (exact in f32, < 2^-10 |x|; the mma
// reads its top 11 bits), and each product is three
// mma.sync.m16n8k8 TF32 products, hi*hi + hi*lo + lo*hi, summed in f32:
// what is dropped (lo*lo, and lo's bits past TF32) is ~2^-21 relative.
// The split is an integer AND and an f32 subtract: with cvt.rna.tf32.f32
// in their place the kernel was slower on an H100.  4*D flops per live
// (query, key) pair, three times over, at the dense TF32 rate.  bf16
// operands are exact in TF32: Q K^T is one product, and P V two (P split,
// V exact).
//
// Design (FlashAttention-2's shape).  A block of WARPS warps owns
// 16 * WARPS queries; each warp owns 16 query rows and keeps its logits S
// (16 x BKV) and output O (16 x D) in mma C fragments, and its row max and
// sum in registers (the max is reduced over the quad that shares a row by
// shuffles each tile; the sum only at the end).  Q sits in shared memory,
// pre-scaled in f32 as the reference scales it (bf16: unscaled, exact, and
// the scale applied to the f32 logits).  K and V tiles of BKV keys have
// their own shared-memory buffers in a two-stage cp.async ring: tile kt+1
// is copied while tile kt is computed, behind one barrier a tile.  P never
// leaves registers: within each 8-key step the k index of P V is permuted
// (A column t <-> key 2t, t+4 <-> key 2t+1), so P's C fragment is already
// the A fragment, and V's B fragment reads rows 2t and 2t+1.  In f32, Q's
// and K's fragments come by ldmatrix (four 8 x 4-word matrices an
// instruction).  Rows are padded (4 floats, 8 bf16) so that every fragment
// read is free of bank conflicts.  exp is the SFU's ex2 with log2(e) folded into the logits'
// factor.
// Only the kv tiles that hold a live key for some query of the block are
// visited (the TPU kernel's pl.when skip), and a warp skips the tiles with
// no live key for its own 16 rows, so a sliding-window layer costs
// O(S * window).  Rows and keys past S are zero-filled and masked, so S
// need not be a multiple of any tile.  Blocks are numbered so that the q
// tiles with the most kv tiles (the last ones, under the causal mask)
// start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

// Per head dim: warps a block (16 query rows each) and keys a kv tile.  At
// D = 256 the f32 O fragment alone is 128 registers a thread; 4 warps and
// 32-key tiles keep Q, two K and two V tiles within 227 KB.
template <int D> struct Cfg {
  static constexpr int WARPS = D == 256 ? 4 : 8;
  static constexpr int BKV = D == 256 ? 32 : 64;
  static constexpr int BQ = 16 * WARPS;
};

template <typename T> struct Pad { static constexpr int value = 8; };  // bf16
template <> struct Pad<float> { static constexpr int value = 4; };

template <typename T, int D>
constexpr size_t smem_bytes() {
  constexpr int LD = D + Pad<T>::value;
  return sizeof(T) * (size_t)LD * (Cfg<D>::BQ + 4 * Cfg<D>::BKV);  // Q, 2 x (K, V)
}

// hi = x truncated to TF32, lo = x - hi (the mma ignores lo's low 13 bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x by the SFU (ex2.approx: ~2^-22 relative; 2^(-2e38) is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// d += a * b, m16n8k8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a += hi(x) * hi(y) + hi(x) * lo(y) + lo(x) * hi(y), small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// Four 8 x 8 b16 matrices (8 x 4 words each) from shared memory; lane
// 8m + r gives the address of row r of matrix m, and register m of lane
// 4r + c gets word c of row r.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte copy global -> shared; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * Cfg<D>::WARPS, 1)
flash_mma_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                 T* __restrict__ O, int BH, int S, int window, float scale) {
  constexpr bool EXACT = std::is_same_v<T, __nv_bfloat16>;  // operands exact in TF32
  constexpr int WARPS = Cfg<D>::WARPS, BKV = Cfg<D>::BKV, BQ = Cfg<D>::BQ;
  constexpr int THREADS = 32 * WARPS;
  constexpr int LD = D + Pad<T>::value;     // shared row stride, elements
  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte copy
  constexpr int NT = BKV / 8;               // key n-tiles of S, k-steps of P V
  constexpr int NO = D / 8;                 // column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LD]
  T* Ks = Qs + BQ * LD;                     // [2][BKV][LD]
  T* Vs = Ks + 2 * BKV * LD;                // [2][BKV][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // mma fragment coordinates
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int qi = nq - 1 - blockIdx.x / BH;  // longest causal rows first
  const int q0 = qi * BQ;
  const long long base = (long long)bh * S * D;
  Q += base;
  K += base;
  V += base;
  O += base;

  // Copies of kv tile kt into ring stage st (rows past S zero-filled).
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BKV;
    T* kd = Ks + st * BKV * LD;
    T* vd = Vs + st * BKV * LD;
    for (int e = tid; e < BKV * D / VEC; e += THREADS) {
      const int r = e / (D / VEC), c = (e % (D / VEC)) * VEC;
      const bool live = k0 + r < S;
      const long long off = live ? (long long)(k0 + r) * D + c : 0;
      cp_async16(kd + r * LD + c, K + off, live ? 16 : 0);
      cp_async16(vd + r * LD + c, V + off, live ? 16 : 0);
    }
    cp_async_commit();
  };

  // The kv tiles that hold a live key for some query of this block.
  const int q_last = min(q0 + BQ - 1, S - 1);
  const int kt_hi = q_last / BKV;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BKV : 0;
  load_kv(kt_lo, 0);

  // Q tile by 16-byte loads; f32 is scaled as the reference scales it.
  for (int e = tid; e < BQ * D / VEC; e += THREADS) {
    const int r = e / (D / VEC), c = (e % (D / VEC)) * VEC;
    T* dst = Qs + r * LD + c;
    if (q0 + r < S) {
      const int4 raw = *reinterpret_cast<const int4*>(Q + (long long)(q0 + r) * D + c);
      if constexpr (EXACT) {
        *reinterpret_cast<int4*>(dst) = raw;
      } else {
        float4 f = *reinterpret_cast<const float4*>(&raw);
        f.x *= scale; f.y *= scale; f.z *= scale; f.w *= scale;
        *reinterpret_cast<float4*>(dst) = f;
      }
    } else {
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  }

  // This warp's rows, and the logits' factor into the log2 domain.
  const int wq0 = q0 + 16 * warp;
  const int wq_last = min(wq0 + 15, S - 1);
  const float logit_mult = EXACT ? scale * LOG2E : LOG2E;
  const T* qrow0 = Qs + (16 * warp + g) * LD;
  const T* qrow1 = qrow0 + 8 * LD;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed for every thread; tile kt-1 is no longer read
    if (kt < kt_hi) load_kv(kt + 1, st ^ 1);

    const int k0 = kt * BKV;
    // Skip a tile with no live key for this warp's rows.
    if (k0 > wq_last || wq0 >= S || (window > 0 && k0 + BKV - 1 <= wq0 - window)) continue;
    const T* ks = Ks + st * BKV * LD;
    const T* vs = Vs + st * BKV * LD;

    // S = Q K^T over D in k-steps of 8.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int c0 = 0; c0 < D; c0 += 8) {
      if constexpr (EXACT) {
        uint32_t ah[4];
        ah[0] = __float_as_uint(to_f32(qrow0[c0 + t]));
        ah[1] = __float_as_uint(to_f32(qrow1[c0 + t]));
        ah[2] = __float_as_uint(to_f32(qrow0[c0 + t + 4]));
        ah[3] = __float_as_uint(to_f32(qrow1[c0 + t + 4]));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* kr = ks + (8 * j + g) * LD + c0 + t;
          mma(s[j], ah, __float_as_uint(to_f32(kr[0])), __float_as_uint(to_f32(kr[4])));
        }
      } else {
        // f32: each fragment is 8 x 4 words of rows in shared memory, which
        // ldmatrix reads four at a time (lane 8m + r gives row r of matrix m).
        uint32_t q[4], ah[4], al[4];
        ldsm4(q, Qs + (16 * warp + lane % 8 + 8 * (lane / 8 % 2)) * LD + c0 + 4 * (lane / 16));
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(q[i]), ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kb[4], bh[4], bl[4];  // b0, b1 of n-tile j, then of j + 1
          ldsm4(kb, ks + (8 * (j + lane / 16) + lane % 8) * LD + c0 + 4 * (lane / 8 % 2));
#pragma unroll
          for (int i = 0; i < 4; ++i) split(__uint_as_float(kb[i]), bh[i], bl[i]);
          mma3(s[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(s[j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }

    // Mask (only where the tile crosses the diagonal, the window's start or
    // S), then the online-softmax update in the log2 domain.
    const bool edge = k0 + BKV - 1 > wq0 || k0 + BKV > S ||
                      (window > 0 && k0 <= wq_last - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * logit_mult;
        if (edge) {
          const int qp = wq0 + g + 8 * (e / 2);
          const int kp = k0 + 8 * j + 2 * t + (e % 2);
          const bool live = kp <= qp && kp < S && (window <= 0 || kp > qp - window);
          x = live ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == NEG_INF ? 0.f : ex2(x - m[e / 2]);
        s[j][e] = p;
        l[e / 2] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P V over the tile's keys in k-steps of 8; P's C fragment is the
    // A fragment under the permutation A column t <-> key 2t, t+4 <-> 2t+1.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(pa[i], ph[i], pl[i]);
      const T* v0 = vs + (8 * j + 2 * t) * LD + g;
      const T* v1 = v0 + LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float b0 = to_f32(v0[8 * n]), b1 = to_f32(v1[8 * n]);
        if constexpr (EXACT) {
          mma(o[n], pl, __float_as_uint(b0), __float_as_uint(b1));
          mma(o[n], ph, __float_as_uint(b0), __float_as_uint(b1));
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split(b0, bh0, bl0);
          split(b1, bh1, bl1);
          mma3(o[n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
  }

  // The row sums over the quad, then O / max(l, 1e-30) in q's type.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    if (row >= S) continue;
    T* orow = O + (long long)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = o[n][2 * r] * l[r], x1 = o[n][2 * r + 1] * l[r];
      if constexpr (EXACT)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(x0, x1);
      else
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
           int window, void* stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + Cfg<D>::BQ - 1) / Cfg<D>::BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));  // as the reference rounds it
  flash_mma_kernel<T, D><<<(unsigned)blocks, 32 * Cfg<D>::WARPS, smem,
                           (cudaStream_t)stream>>>(
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

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o: (BH, S, D) contiguous and
// 16-byte aligned; D in {16, 32, 64, 128, 256}; window <= 0 means plain
// causal.  Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int dtype, int BH, int S, int D, int window,
                                     void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 0) return dispatch<float>(q, k, v, o, BH, S, D, window, stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, BH, S, D, window, stream);
  return (int)cudaErrorInvalidValue;
}
