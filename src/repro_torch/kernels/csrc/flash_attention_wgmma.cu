// Causal (optionally sliding-window) flash attention, forward, bf16, on the
// tensor cores, for sm_90a.
//
//   O[b] = softmax(mask((q[b] @ k[b]^T) * scale)) @ v[b],   scale = 1/sqrt(D)
//
// keeping key j for query i iff j <= i, and also j > i - window when
// window > 0.  q and k are (BH, S, D), v and O (BH, S, DV), bf16,
// contiguous, with (D, DV) in {(64, 64), (128, 128), (256, 256)} and MLA's
// (192, 128) (models/mla.py: 128 + 64 rope columns of q and k, v 128).
// The tensor-core route of src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel); csrc/flash_attention.cu keeps f32 and
// D in {16, 32}.
//
// The numbers are the reference's, to f32 rounding:
// * S = Q K^T is a wgmma of bf16 inputs into f32: every product is exact
//   and every sum f32.  ``scale`` multiplies the f32 logits; Q is never
//   pre-scaled in bf16, which would put 2^-9 relative into every logit where
//   scale is not a power of two (D = 128).
// * The online softmax (running max m, normaliser l, rescaled accumulator)
//   runs in f32 on the accumulator fragments; masked logits are -2e38 and
//   the output is acc / max(l, 1e-30), as in the reference.
// * P stays at f32 accuracy through P V: P_hi = bf16(P), P_lo =
//   bf16(P - P_hi), and O += P_hi V + P_lo V, two wgmmas whose sum differs
//   from P V by at most 2^-18 of P.  A single bf16 P would put 2^-9 into
//   every weight, far past one bf16 ulp of the output.
//
// Bound: operations, 2 (D + DV) flops per live (query, key) pair at the
// bf16 tensor-core rate (the P split costs 1.5x the P V part in issued
// work).
//
// Design.  The kernel is a template on the two head dims (D, DV).  One
// block owns BQ = 64 queries per consumer warpgroup: two consumer
// warpgroups at D and DV <= 192, one at 256 (the O accumulator alone is
// then 128 f32 registers a thread).  A producer warp issues TMA loads:
// the block's Q once, then the K and V tiles of 64 keys through a ring of
// two slots with full / empty mbarriers, all with the 128-byte swizzle
// (a row of D bf16 is D / 64 boxes of 64 x 64; a slot holds K's D / 64
// boxes, then V's DV / 64).  Each consumer
//   1. issues S = Q K^T as wgmma.m64n64k16 with Q and K both read K-major
//      from their natural (S, D) rows;
//   2. scales, masks and exponentiates S in registers, with row max and
//      row sum over the four lanes of a quad (shuffles);
//   3. repacks P from the accumulator fragment into A-operand registers
//      (the same thread owns the same elements) as P_hi and P_lo, and
//      issues O += P V as wgmma.m64nDVk16 with P from registers and V read
//      MN-major through the transpose-B bit;
//   4. releases the slot.
// Only the kv tiles that hold a live key for some query of the block are
// loaded, and a warpgroup for which a tile holds none skips its products
// (the TPU kernel's pl.when), so a sliding-window layer costs O(S * window).
// TMA writes zeros past S, and ragged tails are masked.  Blocks are numbered
// so that the query tiles with the most kv tiles start first.

#include "hopper.cuh"

#include <cmath>

namespace {

constexpr float NEG_INF = -2.0e38f;
using bf16 = __nv_bfloat16;

template <int D, int DV>
struct Cfg {
  static constexpr int WG = D == 256 || DV == 256 ? 1 : 2;  // consumer warpgroups
  static constexpr int BQ = 64 * WG;              // queries per block
  static constexpr int BKV = 64;                  // keys per tile
  static constexpr int TILE = 64 * D * 2;         // bytes of 64 rows of D bf16 (Q, K)
  static constexpr int TILE_V = 64 * DV * 2;      // bytes of 64 rows of DV bf16 (V)
  static constexpr int STAGE = TILE + TILE_V;     // one slot: K, then V
  static constexpr int ATOM = 64 * 128;           // one 64-row x 64-column box
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 128 * WG + 32;   // + the producer warp
  static constexpr size_t SMEM =
      1024 + (size_t)WG * TILE + (size_t)STAGES * STAGE + (2 * STAGES + 1) * sizeof(uint64_t);
};

template <int DV>
__device__ __forceinline__ void pv(float (&o)[DV / 2], const uint32_t (&a)[4], uint64_t dv) {
  if constexpr (DV == 64) hopper::wgmma_rs_n64(o, a, dv);
  if constexpr (DV == 128) hopper::wgmma_rs_n128(o, a, dv);
  if constexpr (DV == 256) hopper::wgmma_rs_n256(o, a, dv);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x, with results below 2^-126 flushed to 0 (they add nothing to a sum
// of weights of which the largest is 1).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D, int DV>
__global__ void __launch_bounds__(Cfg<D, DV>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ O, int BH, int S,
                   int window, float scale_log2) {
  using C = Cfg<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;                       // [WG][D / 64][64 rows][64]
  uint8_t* KV = Qs + C::WG * C::TILE;       // [STAGES][K [D / 64], V [DV / 64]][64 rows][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int nq = (S + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * C::BQ;  // longest causal rows first

  // The kv tiles that hold a live key for some query of this block.
  const int kt_hi = min(q0 + C::BQ - 1, S - 1) / C::BKV;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / C::BKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * C::WG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * C::WG) {
    // Producer warp: one lane issues every load.
    if (threadIdx.x == 128 * C::WG) {
      hopper::prefetch_map(&map_q);
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      hopper::mbar_arrive_expect_tx(qbar, C::WG * C::TILE);
      for (int w = 0; w < C::WG; ++w)
        for (int a = 0; a < D / 64; ++a)
          hopper::tma_load_3d(Qs + w * C::TILE + a * C::ATOM, &map_q, qbar, 64 * a,
                              q0 + 64 * w, bh);
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int it = kt - kt_lo, s = it % C::STAGES;
        hopper::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        uint8_t* ks = KV + s * C::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], C::STAGE);
        // K's and V's boxes in turn (K's last box alone where D > DV)
        for (int a = 0; a < D / 64; ++a) {
          hopper::tma_load_3d(ks + a * C::ATOM, &map_k, &full[s], 64 * a, kt * C::BKV, bh);
          if (a < DV / 64)
            hopper::tma_load_3d(ks + C::TILE + a * C::ATOM, &map_v, &full[s], 64 * a,
                                kt * C::BKV, bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroup w: queries qw0 .. qw0 + 63; this thread holds rows
  // r0 and r0 + 8 of them (accumulator register i: row r0 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (lane % 4) + i % 2).
  // Read through a shuffle, so that the compiler knows w (and every branch
  // on it) is uniform in the warpgroup: a wgmma on a path it takes as
  // divergent is serialized.
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int qw0 = q0 + 64 * w;
  const int r0 = qw0 + warp * 16 + lane / 4;
  // This warpgroup's live kv tiles (none when its rows all lie past S).
  const int my_hi = qw0 < S ? min(qw0 + 63, S - 1) / C::BKV : -1;
  const int my_lo = window > 0 ? max(0, qw0 - window + 1) / C::BKV : 0;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(qbar, 0);
  const uint32_t qs = hopper::smem_u32(Qs + w * C::TILE);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int it = kt - kt_lo, s = it % C::STAGES;
    // Wait even for a skipped tile: its release must not count towards the
    // slot's previous round.
    hopper::mbar_wait(&full[s], (it / C::STAGES) & 1);
    if (kt < my_lo || kt > my_hi) {
      hopper::mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t ks = hopper::smem_u32(KV + s * C::STAGE);
    const uint32_t vs = ks + C::TILE;

    // 1. S = Q K^T: 16 columns of D per wgmma, 32 bytes apart in a box row.
    float sc[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::ATOM + (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(sc, hopper::desc_sw128(qs + off, 16, 1024),
                              hopper::desc_sw128(ks + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // 2. Scale in f32 (by scale * log2(e), so that exp(x) is exp2 of the
    // product), mask only the tiles that cross the diagonal, the window's
    // edge or S, then the online-softmax update in the log2 domain.
    const int k0 = kt * C::BKV;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    const bool all_live = k0 + C::BKV - 1 <= qw0 && k0 + C::BKV - 1 < S &&
                          (window <= 0 || k0 > qw0 + 63 - window);
    if (!all_live) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qp = r0 + 8 * ((i / 2) % 2);
        const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (!(kp <= qp && kp < S && (window <= 0 || kp > qp - window))) sc[i] = NEG_INF;
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      // A row with no live key yet keeps m = -2e38; subtracting 0 instead
      // sends its masked logits to exp2(-2e38) = 0.
      const float m_sub = m_new == NEG_INF ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          sc[i] = fast_exp2(sc[i] - m_sub);
          sum += sc[i];
        }
      alpha[h] = m[h] == m_new ? 1.f : fast_exp2(m[h] - m_sub);
      l[h] = l[h] * alpha[h] + quad_sum(sum);
      m[h] = m_new;
    }
    // Rescale O only when some row's max moved (x * 1 is exact, so skipping
    // changes no number); after the first tiles it rarely does.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }

    // 3. P as A operand: for keys 16 kk .. 16 kk + 15, register r holds the
    // pair of accumulator chunk 2 kk + r / 2 on row half r % 2.
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * kk + r / 2) + 2 * (r % 2);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[i], sc[i + 1]);
        p_hi[kk][r] = bits(hi);
        p_lo[kk][r] = bits(__floats2bfloat162_rn(sc[i] - __low2float(hi),
                                                 sc[i + 1] - __high2float(hi)));
      }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // V MN-major: 16 keys are 2048 bytes on; its DV / 64 boxes ATOM apart.
      const uint64_t dv = hopper::desc_sw128(vs + 2048 * kk, C::ATOM, 1024);
      pv<DV>(o, p_hi[kk], dv);
      pv<DV>(o, p_lo[kk], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);

    // 4. Release the slot.
    hopper::mbar_arrive(&empty[s]);
  }

  const long long base = (long long)bh * S * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= S) continue;
    const float lh = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(O + base + (long long)row * DV + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / lh, o[4 * j + 2 * h + 1] / lh);
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int window,
           void* stream) {
  using C = Cfg<D, DV>;
  CUtensorMap mq, mk, mv;
  if (!hopper::map_bf16_3d(&mq, q, D, S, BH, 64, 64) ||
      !hopper::map_bf16_3d(&mk, k, D, S, BH, 64, 64) ||
      !hopper::map_bf16_3d(&mv, v, DV, S, BH, 64, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)BH * ((S + C::BQ - 1) / C::BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // scale = 1/sqrt(D) (q's width) as the reference rounds it, times log2(e)
  const float scale_log2 = (float)(1.0 / sqrt((double)D)) * 1.4426950408889634f;
  flash_wgmma_kernel<D, DV><<<(unsigned)blocks, C::THREADS, C::SMEM, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, BH, S, window, scale_log2);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// bf16 only.  q, k: (BH, S, D); v, o: (BH, S, DV); contiguous with 16-byte
// aligned bases; (D, DV) in {(64, 64), (128, 128), (256, 256), (192, 128)};
// window <= 0 means plain causal.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for operands outside that rule, or when the tensor
// maps cannot be encoded).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                           int BH, int S, int D, int DV, int window,
                                           void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  if (D == DV) {
    switch (D) {
      case 64: return launch<64, 64>(q, k, v, o, BH, S, window, stream);
      case 128: return launch<128, 128>(q, k, v, o, BH, S, window, stream);
      case 256: return launch<256, 256>(q, k, v, o, BH, S, window, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D == 192 && DV == 128) return launch<192, 128>(q, k, v, o, BH, S, window, stream);
  return (int)cudaErrorInvalidValue;
}
