// RWKV-6 WKV (linear attention with data-dependent decay), for sm_90a.
//
// Per batch row b and head h, with a (HD x HD) f32 state St (key index i,
// value index j) and, per token t, kv = k_t v_t^T:
//
//   out_t = r_t (St + diag(u) kv),    St <- diag(exp(logw_t)) St + kv.
//
// r, k, v, out are (B, S, H, HD) in the model's layout, f32 or bf16; logw
// (B, S, H, HD) f32 with logw <= 0; u (H, HD) f32; state0 and the final
// state (B, H, HD, HD) f32.  Every product and sum is taken in f32 and out
// is written in r's type.
//
// Replaces src/repro/kernels/rwkv6.py:wkv (_wkv_kernel): the same chunked
// form, per chunk of C = 64 tokens an intra-chunk masked (C x C) term, the
// r . state term and the diagonal bonus, with the state carried in f32.
//
// Numerics.  The TPU kernel and the reference model form k * exp(-cum),
// which overflows f32 inside the model's own decay range (logw down to
// -e^2: 64 tokens of it is exp(473)).  Here every decay is a difference of
// cumulative log-decays that is <= 0: exp(cum_{t-1} - cum_s) for s < t,
// exp(cum_{t-1}) on r, and exp(cum_last - cum_s) on k.  The cumulative
// sums are f32 sums of non-positive terms, so they are non-increasing and
// each difference is <= 0 as rounded; exponents are taken base 2 on sums
// scaled by log2(e).
//
// Bound: operations.  Per chunk of n tokens, 2 * HD flops per live (t, s)
// pair s <= t for the decayed r . k products and 2 * HD more for P @ V,
// and 2 * HD^2 per token each for r . state and the state update, on the f32
// CUDA cores (the decays are f32, so bf16 tensor cores would round them).
//
// Design.  The TPU kernel walks the chunks as a sequential grid axis and
// carries the state in VMEM.  Here one block of 256 threads owns one
// (b, h) and loops over the chunks inside the block, with the state in
// shared memory.  Each chunk is staged in shared memory in f32 (r and the
// exclusive cumulative decay transposed, [i][t]; k, the inclusive
// cumulative decay and v as [t][i]), reading the (B, S, H, HD) layout in
// place, with no transpose around the kernel.  Then: the cumulative sums
// (one thread per key channel) and the bonus diagonal; the masked (C x C)
// matrix P[s][t] = sum_i r_ti k_si exp2(x_ti - c_si), one thread per query
// t over 16 keys s, the keys' k and c read as warp-wide broadcasts, with
// the bonus on the diagonal; r and k are decayed in place; out = r' St +
// P^T v in 4 x 4 register tiles; and St <- exp(A) St + k'^T v.  A ragged
// last chunk is padded with zeros (logw 0), so S need not be a multiple of
// C: the TPU's S % chunk assert is not kept.  HD is 16, 32 or 64 (122 KB
// of shared memory at 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;          // tokens per chunk
constexpr int CP = C + 4;      // row stride of the [i][t] and [s][t] arrays
constexpr int THREADS = 256;
constexpr int KEYS = 16;       // keys per thread in the P pass
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int HP = HD + 4;
  // rT, xT [HD][CP]; kS, cS, vS [C][HP]; P [C][CP]; St [HD][HP]; u [HD]; diag [C]
  return sizeof(float) * ((size_t)2 * HD * CP + (size_t)3 * C * HP + (size_t)C * CP +
                          (size_t)HD * HP + HD + C);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
wkv_kernel(const T* __restrict__ R, const T* __restrict__ K, const T* __restrict__ V,
           const float* __restrict__ LW, const float* __restrict__ U,
           const float* __restrict__ S0, T* __restrict__ O, float* __restrict__ SOUT,
           int S, int H) {
  static_assert(HD % 4 == 0 && HD + C <= THREADS, "HD must be a multiple of 4, at most 192");
  static_assert(C == 4 * KEYS && THREADS == 8 * 32, "the P pass maps 8 warps on 64 x 64");
  constexpr int HP = HD + 4;
  constexpr int JT = HD / 4;  // 4-wide column tiles
  extern __shared__ __align__(16) float smem[];
  float* rT = smem;            // [HD][CP]  r, then r_t * exp(cum_{t-1})
  float* xT = rT + HD * CP;    // [HD][CP]  cum_{t-1} * log2(e), exclusive
  float* kS = xT + HD * CP;    // [C][HP]   k, then k_s * exp(A - cum_s)
  float* cS = kS + C * HP;     // [C][HP]   logw, then cum_s * log2(e), inclusive
  float* vS = cS + C * HP;     // [C][HP]
  float* P = vS + C * HP;      // [C][CP]   P[s][t]
  float* St = P + C * CP;      // [HD][HP]  state[i][j]
  float* uS = St + HD * HP;    // [HD]
  float* dg = uS + HD;         // [C]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long tok = (long long)H * HD;  // elements between tokens
  const long long base = (long long)b * S * tok + (long long)h * HD;

  for (int e = tid; e < HD; e += THREADS) uS[e] = U[h * HD + e];
  for (int e = tid; e < HD * HD; e += THREADS)
    St[(e / HD) * HP + e % HD] = S0 ? S0[(long long)bh * HD * HD + e] : 0.f;

  for (int t0 = 0; t0 < S; t0 += C) {
    const int n = min(C, S - t0);

    // 1. Stage the chunk; rows past n are zeros (logw 0: no decay).
    for (int e = tid; e < C * HD; e += THREADS) {
      const int t = e / HD, i = e % HD;
      const bool live = t < n;
      const long long g = base + (long long)(t0 + t) * tok + i;
      rT[i * CP + t] = live ? to_f32(R[g]) : 0.f;
      kS[t * HP + i] = live ? to_f32(K[g]) : 0.f;
      vS[t * HP + i] = live ? to_f32(V[g]) : 0.f;
      cS[t * HP + i] = live ? LW[g] : 0.f;
    }
    __syncthreads();

    // 2. Cumulative log-decays, one thread per key channel; the bonus
    //    diagonal r_t . (u * k_t), one thread per token.
    if (tid < HD) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        xT[tid * CP + t] = run * LOG2E;
        run += cS[t * HP + tid];
        cS[t * HP + tid] = run * LOG2E;
      }
    } else if (tid < HD + C) {
      const int t = tid - HD;
      float d = 0.f;
      for (int i = 0; i < HD; ++i) d = fmaf(rT[i * CP + t], uS[i] * kS[t * HP + i], d);
      dg[t] = d;
    }
    __syncthreads();

    // 3. P[s][t] = sum_i r_ti k_si exp2(x_ti - c_si) for s < t, the bonus at
    //    s = t, 0 above.  Warp w: queries t = 32 (w & 1) + lane, keys
    //    s0 = 16 (w >> 1) .. s0 + 15.
    {
      const int warp = tid / 32, lane = tid % 32;
      const int t = (warp & 1) * 32 + lane;
      const int s0 = (warp >> 1) * KEYS;
      float acc[KEYS];
#pragma unroll
      for (int q = 0; q < KEYS; ++q) acc[q] = 0.f;
      if (s0 <= (warp & 1) * 32 + 31) {  // some lane of the warp has a live pair
#pragma unroll 2
        for (int i = 0; i < HD; i += 4) {
          float rv[4], xv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            rv[q] = rT[(i + q) * CP + t];
            xv[q] = xT[(i + q) * CP + t];
          }
#pragma unroll
          for (int q = 0; q < KEYS; ++q) {
            const float4 k4 = *reinterpret_cast<const float4*>(&kS[(s0 + q) * HP + i]);
            const float4 c4 = *reinterpret_cast<const float4*>(&cS[(s0 + q) * HP + i]);
            // min(., 0) only matters above the diagonal, whose values are dropped
            float a = acc[q];
            a = fmaf(rv[0] * k4.x, exp2f(fminf(xv[0] - c4.x, 0.f)), a);
            a = fmaf(rv[1] * k4.y, exp2f(fminf(xv[1] - c4.y, 0.f)), a);
            a = fmaf(rv[2] * k4.z, exp2f(fminf(xv[2] - c4.z, 0.f)), a);
            a = fmaf(rv[3] * k4.w, exp2f(fminf(xv[3] - c4.w, 0.f)), a);
            acc[q] = a;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < KEYS; ++q) {
        const int s = s0 + q;
        P[s * CP + t] = s < t ? acc[q] : (s == t ? dg[t] : 0.f);
      }
    }
    __syncthreads();

    // 4. Decay r and k in place: r_t * exp(cum_{t-1}), k_s * exp(A - cum_s).
    for (int e = tid; e < HD * C; e += THREADS) {
      const int i = e / C, t = e % C;
      rT[i * CP + t] *= exp2f(xT[i * CP + t]);
    }
    for (int e = tid; e < C * HD; e += THREADS) {
      const int s = e / HD, i = e % HD;
      kS[s * HP + i] *= exp2f(fminf(cS[(C - 1) * HP + i] - cS[s * HP + i], 0.f));
    }
    __syncthreads();

    // 5. out[t][j] = sum_i r'[t][i] St[i][j] + sum_{s <= t} P[s][t] v[s][j].
    for (int tile = tid; tile < (C / 4) * JT; tile += THREADS) {
      const int tl = (tile / JT) * 4, j0 = (tile % JT) * 4;
      float o[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
#pragma unroll 4
      for (int i = 0; i < HD; ++i) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rT[i * CP + tl]);
        const float4 s4 = *reinterpret_cast<const float4*>(&St[i * HP + j0]);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[a][c] = fmaf(rv[a], sv[c], o[a][c]);
      }
      const int s_hi = min(tl + 3, n - 1);
      for (int s = 0; s <= s_hi; ++s) {
        const float4 p4 = *reinterpret_cast<const float4*>(&P[s * CP + tl]);
        const float4 v4 = *reinterpret_cast<const float4*>(&vS[s * HP + j0]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[a][c] = fmaf(pv[a], vv[c], o[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (tl + a >= n) continue;
        T* dst = O + base + (long long)(t0 + tl + a) * tok + j0;
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = from_f32<T>(o[a][c]);
      }
    }
    __syncthreads();  // St is read before it is updated

    // 6. St[i][j] <- exp(A_i) St[i][j] + sum_s k'[s][i] v[s][j].
    for (int tile = tid; tile < JT * JT; tile += THREADS) {
      const int i0 = (tile / JT) * 4, j0 = (tile % JT) * 4;
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float decay = exp2f(cS[(C - 1) * HP + i0 + a]);
        const float4 s4 = *reinterpret_cast<const float4*>(&St[(i0 + a) * HP + j0]);
        s[a][0] = s4.x * decay;
        s[a][1] = s4.y * decay;
        s[a][2] = s4.z * decay;
        s[a][3] = s4.w * decay;
      }
      for (int q = 0; q < n; ++q) {
        const float4 k4 = *reinterpret_cast<const float4*>(&kS[q * HP + i0]);
        const float4 v4 = *reinterpret_cast<const float4*>(&vS[q * HP + j0]);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = fmaf(kv[a], vv[c], s[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(&St[(i0 + a) * HP + j0]) =
            make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    __syncthreads();  // the next chunk overwrites kS, vS, cS
  }

  for (int e = tid; e < HD * HD; e += THREADS)
    SOUT[(long long)bh * HD * HD + e] = St[(e / HD) * HP + e % HD];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* o, void* sout, int B, int S, int H, void* stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(wkv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wkv_kernel<T, HD><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)lw, (const float*)u,
      (const float*)s0, (T*)o, (float*)sout, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* lw, const void* u,
             const void* s0, void* o, void* sout, int B, int S, int H, int HD,
             void* stream) {
  switch (HD) {
    case 16: return launch<T, 16>(r, k, v, lw, u, s0, o, sout, B, S, H, stream);
    case 32: return launch<T, 32>(r, k, v, lw, u, s0, o, sout, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, lw, u, s0, o, sout, B, S, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v, out): 0 = float32, 1 = bfloat16.  r, k, v, logw, out:
// (B, S, H, HD) contiguous; u: (H, HD); state0 (or NULL for zeros) and
// state_out: (B, H, HD, HD); logw, u and the states f32.  HD in {16, 32, 64}.
// S may be 0: state_out is then state0.  Returns the cudaError_t of the
// launch.
extern "C" int repro_wkv(const void* r, const void* k, const void* v, const void* logw,
                         const void* u, const void* state0, void* out, void* state_out,
                         int dtype, int B, int S, int H, int HD, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (dtype == 0) return dispatch<float>(r, k, v, logw, u, state0, out, state_out, B, S, H, HD,
                                         stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(r, k, v, logw, u, state0, out, state_out, B, S,
                                                 H, HD, stream);
  return (int)cudaErrorInvalidValue;
}
