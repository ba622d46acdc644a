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
// form, per chunk of C = 64 tokens an intra-chunk masked (C x C) matrix P
// with the bonus on its diagonal, the r . state term and the state update.
//
// Numerics.  The TPU kernel and the reference model form k * exp(-cum),
// which overflows f32 inside the model's own decay range (logw down to
// -e^2: 64 tokens of it is exp(473)).  Here every exponent is a difference
// of cumulative log-decays (base 2) that is <= 0, clamped with fminf(., 0)
// where a scan order could break monotonicity by an ulp.  With x_t the
// cumulative decay before token t and c_s the one through token s, P's
// entry for a key s < t is sum_i r_ti k_si exp2(x_ti - c_si).  Its tokens
// fall in sub-chunks of L = 16; for a key in an earlier sub-chunk than t's,
// whose start is ``ref``,
//
//   exp2(x_t - c_s) = exp2(x_t - x_ref) * exp2(x_ref - c_s),
//
// both factors <= 0 in the exponent: r decayed once per token to its
// sub-chunk's start (rq), k once per (key, later sub-chunk) (kq), and the
// off-diagonal sub-blocks of P are plain f32 products rq . kq.  Only the
// diagonal sub-blocks keep the pairwise exp2.  At HD = 64 a chunk takes
// 41 K exponentials for P (over the whole cluster) and 8 K in each block for
// its decayed r and k, 74 K in all, instead of 262 K.
//
// Bound: operations.  Per chunk of n tokens, 2 * HD flops per live (t, s)
// pair s <= t for r . k and 2 * HD more for P @ V, and 2 * HD^2 per token
// each for r . state and the state update, on the f32 CUDA cores (the
// decays are f32: tensor cores in TF32 or bf16 would round them).
//
// Design.  out[:, j] and the state's column j depend only on v[:, j], so a
// block of 128 threads owns (b, h, 16 value columns): its (HD x 16) slice of
// the state, in shared memory, and of out; HD / 16 blocks per (b, h) form a
// thread-block cluster.  Each block stages the chunk by cp.async (16-byte
// copies, reading the (B, S, H, HD) layout in place; a ragged last chunk is
// zero-filled, logw 0: no decay).  Per chunk: the cumulative decays (each
// thread holds a segment of tokens in registers, the segments joined by a
// warp-shuffle scan); the rows of P for the query sub-chunks the block owns
// (sub-chunk q belongs to rank q % (HD/16)), written to its own shared
// memory; r and k decayed to the chunk's start and end; then two warps form
// out = r' St + P^T v over 4x4 register tiles, after a cluster barrier,
// reading P's rows from their owners through distributed shared memory,
// while the other two issue the next chunk's copies (its inputs are
// consumed) and form St <- exp(A) St + k'^T v into a second state buffer.
// The flops of P are those of one P per (b, h).  A split cluster barrier
// (arrive after the reads, wait before the next chunk's writes) keeps a
// block from overwriting rows another still reads.  HD is 16, 32 or 64 (1,
// 2 or 4 blocks a cluster); shared memory stays under 113 KB so that two
// blocks fit on an SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 64;           // tokens per chunk
constexpr int L = 16;           // tokens per sub-chunk
constexpr int NSUB = C / L;
constexpr int COLS = 16;        // value columns per block
constexpr int THREADS = 128;
constexpr int PS = C + 4;       // row stride of P
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x, x <= 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !live.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <typename T, int HD>
struct Layout {
  static constexpr int G = HD / COLS;                          // blocks per (b, h)
  static constexpr int RS = HD + 16 / (int)sizeof(T);          // raw r, k row stride
  static constexpr int FS = HD + 4;                            // f32 [t][i] row stride
  static constexpr int PROWS = C / G;                          // P rows a block owns
  // element offsets, each a multiple of 16 bytes
  static constexpr size_t rr = 0;                                       // T [C][RS]
  static constexpr size_t rk = rr + (size_t)C * RS * sizeof(T);         // T [C][RS]
  static constexpr size_t rv = rk + (size_t)C * RS * sizeof(T);         // T [C][COLS]
  static constexpr size_t cw = rv + (size_t)C * COLS * sizeof(T);       // f32 [C][FS]
  static constexpr size_t rp = cw + (size_t)C * FS * 4;                 // f32 [C][FS]
  static constexpr size_t kp = rp + (size_t)C * FS * 4;                 // f32 [C][FS]
  static constexpr size_t pw = kp + (size_t)C * FS * 4;                 // f32 [PROWS][PS]
  static constexpr size_t vf = pw + (size_t)PROWS * PS * 4;             // f32 [C][COLS]
  static constexpr size_t st = vf + (size_t)C * COLS * 4;               // f32 [2][HD][COLS]
  static constexpr size_t us = st + (size_t)2 * HD * COLS * 4;         // f32 [HD]
  static constexpr size_t dc = us + (size_t)HD * 4;                     // f32 [HD]
  static constexpr size_t bytes = dc + (size_t)HD * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
wkv_kernel(const T* __restrict__ R, const T* __restrict__ K, const T* __restrict__ V,
           const float* __restrict__ LW, const float* __restrict__ U,
           const float* __restrict__ S0, T* __restrict__ O, float* __restrict__ SOUT,
           int S, int H) {
  using Ly = Layout<T, HD>;
  constexpr int G = Ly::G, RS = Ly::RS, FS = Ly::FS;
  constexpr int Q4 = HD / 4;                 // float4 quads per channel row
  constexpr int NSEG = THREADS / HD;         // scan segments per channel
  constexpr int SEG = C / NSEG;              // tokens per segment
  static_assert(HD % COLS == 0 && G >= 1 && G <= NSUB && NSUB % G == 0, "HD in {16, 32, 64}");
  static_assert(Ly::bytes <= 113 * 1024, "two blocks an SM");
  extern __shared__ __align__(16) unsigned char smem[];
  T* rr = reinterpret_cast<T*>(smem + Ly::rr);
  T* rk = reinterpret_cast<T*>(smem + Ly::rk);
  T* rv = reinterpret_cast<T*>(smem + Ly::rv);
  float* cw = reinterpret_cast<float*>(smem + Ly::cw);  // logw, then cumulative (base 2)
  float* rp = reinterpret_cast<float*>(smem + Ly::rp);  // rq, then r'
  float* kp = reinterpret_cast<float*>(smem + Ly::kp);  // kq, then k'
  float* pw = reinterpret_cast<float*>(smem + Ly::pw);  // the rows of P this block owns
  float* vf = reinterpret_cast<float*>(smem + Ly::vf);
  float* st = reinterpret_cast<float*>(smem + Ly::st);  // this chunk's state
  float* sn = st + HD * COLS;                            // the next chunk's
  float* us = reinterpret_cast<float*>(smem + Ly::us);
  float* dc = reinterpret_cast<float*>(smem + Ly::dc);

  const int tid = threadIdx.x;
  const int g = G > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int bh = blockIdx.x / G;
  const int b = bh / H, h = bh % H;
  const long long tok = (long long)H * HD;  // elements between tokens
  const long long base = (long long)b * S * tok + (long long)h * HD;
  const int j0g = g * COLS;                 // the block's first value column

  for (int e = tid; e < HD; e += THREADS) us[e] = U[h * HD + e];
  for (int e = tid; e < HD * COLS; e += THREADS) {
    const int i = e / COLS, j = e % COLS;
    st[e] = S0 ? S0[((long long)bh * HD + i) * HD + j0g + j] : 0.f;
  }

  // The copies of the chunk at t0, consecutive threads on consecutive 16-byte
  // pieces of a token's row; rows past S are zero-filled.
  auto stage = [&](int t0, int first, int stride) {
    constexpr int RQ = HD * (int)sizeof(T) / 16;     // pieces of an r or k row
    constexpr int WQ = HD / 4;                       // of a logw row
    constexpr int VQ = COLS * (int)sizeof(T) / 16;   // of the block's v columns
    constexpr int EP = 16 / (int)sizeof(T);          // elements a piece
    auto row = [&](int t) {  // a dead row reads nothing: any valid address will do
      return base + (long long)(t0 + t < S ? t0 + t : t0) * tok;
    };
    for (int e = first; e < C * RQ; e += stride) {
      const int t = e / RQ, p = (e % RQ) * EP;
      cp16(rr + t * RS + p, R + row(t) + p, t0 + t < S);
      cp16(rk + t * RS + p, K + row(t) + p, t0 + t < S);
    }
    for (int e = first; e < C * WQ; e += stride) {
      const int t = e / WQ, p = (e % WQ) * 4;
      cp16(cw + t * FS + p, LW + row(t) + p, t0 + t < S);
    }
    for (int e = first; e < C * VQ; e += stride) {
      const int t = e / VQ, p = (e % VQ) * EP;
      cp16(rv + t * COLS + p, V + row(t) + j0g + p, t0 + t < S);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (S > 0) stage(0, tid, THREADS);
  bool pending_b = false;  // a cluster arrive whose wait is still due

  for (int t0 = 0; t0 < S; t0 += C) {
    const int n = min(C, S - t0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // 1. Cumulative log-decays in place, base 2: thread (i, segment) holds
    //    SEG tokens in registers; the segment totals are joined by a shuffle
    //    scan across the NSEG neighbouring lanes of channel i.
    {
      const int seg = tid % NSEG, i = tid / NSEG;
      float w[SEG];
      float tot = 0.f;
#pragma unroll
      for (int u = 0; u < SEG; ++u) {
        w[u] = cw[(seg * SEG + u) * FS + i] * LOG2E;
        tot += w[u];
      }
      float incl = tot;
#pragma unroll
      for (int d = 1; d < NSEG; d <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, d, NSEG);
        if (seg >= d) incl += y;
      }
      float run = __shfl_up_sync(0xffffffffu, incl, 1, NSEG);
      if (seg == 0) run = 0.f;
#pragma unroll
      for (int u = 0; u < SEG; ++u) {
        run += w[u];
        cw[(seg * SEG + u) * FS + i] = run;
      }
    }
    __syncthreads();

    // x_t: the cumulative decay before token t (0 at the chunk's start).
    auto xrow = [&](int t, int i) -> float4 {
      return t > 0 ? ld4(cw + (t - 1) * FS + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    };

    // 2. The rows of P of the sub-chunks this block owns: P[t][s] for
    //    s <= t < 16(q + 1), zeros above the diagonal.
    for (int q = g; q < NSUB; q += G) {
      const int tq = q * L;
      // 2a. rq[t'] = r_t exp2(x_t - x_ref), kq[s] = k_s exp2(x_ref - c_s), s < tq.
      for (int e = tid; e < L * Q4; e += THREADS) {
        const int tl = e / Q4, i = (e % Q4) * 4;
        const float4 xr = xrow(tq, i), xt = xrow(tq + tl, i), r4 = ld4(rr + (tq + tl) * RS + i);
        st4(rp + tl * FS + i, make_float4(r4.x * ex2(fminf(xt.x - xr.x, 0.f)),
                                          r4.y * ex2(fminf(xt.y - xr.y, 0.f)),
                                          r4.z * ex2(fminf(xt.z - xr.z, 0.f)),
                                          r4.w * ex2(fminf(xt.w - xr.w, 0.f))));
      }
      for (int e = tid; e < tq * Q4; e += THREADS) {
        const int s = e / Q4, i = (e % Q4) * 4;
        const float4 xr = xrow(tq, i), c4 = ld4(cw + s * FS + i), k4 = ld4(rk + s * RS + i);
        st4(kp + s * FS + i, make_float4(k4.x * ex2(fminf(xr.x - c4.x, 0.f)),
                                         k4.y * ex2(fminf(xr.y - c4.y, 0.f)),
                                         k4.z * ex2(fminf(xr.z - c4.z, 0.f)),
                                         k4.w * ex2(fminf(xr.w - c4.w, 0.f))));
      }
      __syncthreads();
      if (G > 1 && pending_b) {  // every reader of the previous chunk's rows is done
        cluster_wait();
        pending_b = false;
      }
      // 2b. Thread (t' = tid % 16, g' = tid / 16): the off-diagonal keys
      //     s = g' + 8m < tq.
      {
        const int tl = tid % L, cgp = tid / L;
        const int t = tq + tl;
        float* prow = pw + ((q / G) * L + tl) * PS;
        float acc[2 * (NSUB - 1)];
#pragma unroll
        for (int m = 0; m < 2 * (NSUB - 1); ++m) acc[m] = 0.f;
        for (int i = 0; i < HD; i += 4) {
          const float4 a = ld4(rp + tl * FS + i);
#pragma unroll
          for (int m = 0; m < 2 * (NSUB - 1); ++m)
            if (m < 2 * q) acc[m] = dot4(a, ld4(kp + (cgp + 8 * m) * FS + i), acc[m]);
        }
#pragma unroll
        for (int m = 0; m < 2 * (NSUB - 1); ++m)
          if (m < 2 * q) prow[cgp + 8 * m] = acc[m];
      }
      // The diagonal sub-block as a flat list: the 120 pairs s < t, each with
      // the zero above the diagonal, then the 16 bonuses r_t . (u * k_t).
      constexpr int PAIRS = L * (L - 1) / 2;
      for (int w = tid; w < PAIRS + L; w += THREADS) {
        int tl, sl;
        if (w < PAIRS) {  // w = tl (tl - 1) / 2 + sl, sl < tl
          tl = (int)((1.f + sqrtf(1.f + 8.f * w)) * 0.5f);
          if (tl * (tl - 1) / 2 > w) --tl;
          if (tl * (tl + 1) / 2 <= w) ++tl;
          sl = w - tl * (tl - 1) / 2;
        } else {
          tl = sl = w - PAIRS;
        }
        const int t = tq + tl, s = tq + sl;
        float d0 = 0.f, d1 = 0.f;  // two partial sums: a shorter chain
        if (sl < tl) {  // sum_i r_ti k_si exp2(x_ti - c_si)
#pragma unroll 4
          for (int i = 0; i < HD; i += 4) {
            const float4 r4 = ld4(rr + t * RS + i), xt = xrow(t, i);
            const float4 k4 = ld4(rk + s * RS + i), c4 = ld4(cw + s * FS + i);
            d0 = fmaf(r4.x * k4.x, ex2(fminf(xt.x - c4.x, 0.f)), d0);
            d1 = fmaf(r4.y * k4.y, ex2(fminf(xt.y - c4.y, 0.f)), d1);
            d0 = fmaf(r4.z * k4.z, ex2(fminf(xt.z - c4.z, 0.f)), d0);
            d1 = fmaf(r4.w * k4.w, ex2(fminf(xt.w - c4.w, 0.f)), d1);
          }
          pw[((q / G) * L + sl) * PS + t] = 0.f;
        } else {
          for (int i = 0; i < HD; i += 4) {
            const float4 r4 = ld4(rr + t * RS + i), k4 = ld4(rk + t * RS + i);
            const float4 u4 = ld4(us + i);
            d0 = fmaf(r4.x, u4.x * k4.x, d0);
            d1 = fmaf(r4.y, u4.y * k4.y, d1);
            d0 = fmaf(r4.z, u4.z * k4.z, d0);
            d1 = fmaf(r4.w, u4.w * k4.w, d1);
          }
        }
        pw[((q / G) * L + tl) * PS + s] = d0 + d1;
      }
      __syncthreads();  // rq and kq are reused by the next owned sub-chunk and by step 3
    }
    if (G > 1) cluster_arrive();  // this block's rows of P are written

    // 3. r'_t = r_t exp2(x_t), k'_s = k_s exp2(c_last - c_s), v in f32, and
    //    the chunk's decay exp2(c_last) of the state.
    for (int e = tid; e < C * Q4; e += THREADS) {
      const int t = e / Q4, i = (e % Q4) * 4;
      const float4 xt = xrow(t, i), ct = ld4(cw + t * FS + i), cl = ld4(cw + (C - 1) * FS + i);
      const float4 r4 = ld4(rr + t * RS + i), k4 = ld4(rk + t * RS + i);
      st4(rp + t * FS + i, make_float4(r4.x * ex2(fminf(xt.x, 0.f)), r4.y * ex2(fminf(xt.y, 0.f)),
                                       r4.z * ex2(fminf(xt.z, 0.f)), r4.w * ex2(fminf(xt.w, 0.f))));
      st4(kp + t * FS + i, make_float4(k4.x * ex2(fminf(cl.x - ct.x, 0.f)),
                                       k4.y * ex2(fminf(cl.y - ct.y, 0.f)),
                                       k4.z * ex2(fminf(cl.z - ct.z, 0.f)),
                                       k4.w * ex2(fminf(cl.w - ct.w, 0.f))));
    }
    for (int e = tid; e < C * COLS / 4; e += THREADS) st4(vf + e * 4, ld4(rv + e * 4));
    for (int e = tid; e < HD; e += THREADS) dc[e] = ex2(fminf(cw[(C - 1) * FS + e], 0.f));
    __syncthreads();

    // 4. Two warps form out[t][j] = sum_i r'[t][i] St[i][j] + sum_{s <= t}
    //    P[t][s] v[s][j] over 4x4 tiles (token quad, column quad), reading P's
    //    rows from their owners; the other two, at the same time, the next
    //    state St'[i][j] = exp2(c_last_i) St[i][j] + sum_s k'[s][i] v[s][j]
    //    over 4x4 tiles (channel quad, column quad) into the other buffer,
    //    after issuing the next chunk's copies.
    if (tid < 64) {
      if (G > 1) cluster_wait();  // every block's rows of P are written
      const int ta = (tid / 4) * 4, jq = (tid % 4) * 4;
      if (ta < n) {
        float o[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
        auto mac = [&](const float4 (&x)[4], int row, const float* m) {
          // o[a][:] += sum_w x[a].w-th * m[(row + w) * COLS + jq .. + 3]
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float4 m4 = ld4(m + (row + w) * COLS + jq);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float xa = w == 0 ? x[a].x : w == 1 ? x[a].y : w == 2 ? x[a].z : x[a].w;
              o[a][0] = fmaf(xa, m4.x, o[a][0]);
              o[a][1] = fmaf(xa, m4.y, o[a][1]);
              o[a][2] = fmaf(xa, m4.z, o[a][2]);
              o[a][3] = fmaf(xa, m4.w, o[a][3]);
            }
          }
        };
#pragma unroll 2
        for (int i = 0; i < HD; i += 4) {
          float4 x[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) x[a] = ld4(rp + (ta + a) * FS + i);
          mac(x, i, st);
        }
        const int q = ta / L;
        const float* prow = pw + ((q / G) * L + ta % L) * PS;
        if constexpr (G > 1) prow = cg::this_cluster().map_shared_rank(prow, q % G);
#pragma unroll 2
        for (int s = 0; s < ta + 4; s += 4) {  // P is zero above the diagonal
          float4 x[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) x[a] = ld4(prow + a * PS + s);
          mac(x, s, vf);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (ta + a < n)
            st4(O + base + (long long)(t0 + ta + a) * tok + j0g + jq,
                make_float4(o[a][0], o[a][1], o[a][2], o[a][3]));
      }
      if (G > 1) cluster_arrive();  // this block's reads of other blocks' rows are done
    } else {
      // The staging buffers are free: the next chunk's copies land during 4.
      if (t0 + C < S) stage(t0 + C, tid - 64, THREADS - 64);
      const int i0 = ((tid - 64) / 4) * 4, jq = (tid % 4) * 4;
      if (i0 < HD) {
        float a4[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 s4 = ld4(st + (i0 + a) * COLS + jq);
          const float d = dc[i0 + a];
          a4[a][0] = s4.x * d;
          a4[a][1] = s4.y * d;
          a4[a][2] = s4.z * d;
          a4[a][3] = s4.w * d;
        }
#pragma unroll 4
        for (int q = 0; q < n; ++q) {
          const float4 k4 = ld4(kp + q * FS + i0), v4 = ld4(vf + q * COLS + jq);
          const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            a4[a][0] = fmaf(kv[a], v4.x, a4[a][0]);
            a4[a][1] = fmaf(kv[a], v4.y, a4[a][1]);
            a4[a][2] = fmaf(kv[a], v4.z, a4[a][2]);
            a4[a][3] = fmaf(kv[a], v4.w, a4[a][3]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          st4(sn + (i0 + a) * COLS + jq, make_float4(a4[a][0], a4[a][1], a4[a][2], a4[a][3]));
      }
      if (G > 1) {  // this block reads no other block's rows
        cluster_wait();
        cluster_arrive();
      }
    }
    pending_b = G > 1;
    __syncthreads();  // the next state is written; this chunk's is no longer read
    {
      float* tmp = st;
      st = sn;
      sn = tmp;
    }
  }
  if (G > 1 && pending_b) cluster_wait();  // no block leaves while its P is read
  __syncthreads();

  for (int e = tid; e < HD * COLS; e += THREADS) {
    const int i = e / COLS, j = e % COLS;
    SOUT[((long long)bh * HD + i) * HD + j0g + j] = st[e];
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* o, void* sout, int B, int S, int H, void* stream) {
  using Ly = Layout<T, HD>;
  auto kern = wkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Ly::bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * Ly::G;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Ly::bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Ly::G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)r, (const T*)k, (const T*)v, (const float*)lw,
                           (const float*)u, (const float*)s0, (T*)o, (float*)sout, S, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int info(int* cluster, int* smem, int* active) {
  using Ly = Layout<T, HD>;
  auto kern = wkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Ly::bytes);
  if (err != cudaSuccess) return (int)err;
  *cluster = Ly::G;
  *smem = (int)Ly::bytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Ly::G * 1024);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Ly::bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Ly::G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(active, kern, &cfg);
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

template <typename T>
int dispatch_info(int HD, int* cluster, int* smem, int* active) {
  switch (HD) {
    case 16: return info<T, 16>(cluster, smem, active);
    case 32: return info<T, 32>(cluster, smem, active);
    case 64: return info<T, 64>(cluster, smem, active);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v, out): 0 = float32, 1 = bfloat16.  r, k, v, logw, out:
// (B, S, H, HD) contiguous and 16-byte aligned; u: (H, HD); state0 (or NULL
// for zeros) and state_out: (B, H, HD, HD); logw, u and the states f32.
// HD in {16, 32, 64}.  S may be 0: state_out is then state0.  Returns the
// cudaError_t of the launch.
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

// The launch of repro_wkv at (dtype, HD): blocks per cluster, dynamic shared
// memory per block, and how many such clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters).  Returns a cudaError_t.
extern "C" int repro_wkv_info(int dtype, int HD, int* cluster, int* smem, int* active) {
  if (dtype == 0) return dispatch_info<float>(HD, cluster, smem, active);
  if (dtype == 1) return dispatch_info<__nv_bfloat16>(HD, cluster, smem, active);
  return (int)cudaErrorInvalidValue;
}
