// Batched f32 GEMM on the tensor cores at f32 accuracy (3xTF32), with the
// accumulate-into-output epilogue, for sm_90a.
//
//   O[z] = A[z] @ B[z]            (C == nullptr)
//   O[z] = C[z] + A[z] @ B[z]     (accumulate)
//
// Replaces src/repro/kernels/gemm.py:_gemm_kernel (the DCA analogue) for f32
// operands that TMA and 16-byte loads can address: A (M, K), B (K, N), C and
// O (M, N) row-major and contiguous inside each batch member, K % 4 == 0,
// N % 4 == 0, 16-byte aligned bases.  csrc/gemm.cu keeps the other f32
// calls.  The reference multiplies in f32.
//
// Bound: operations, 2*M*N*K per member at f32 accuracy on the tensor cores,
// 164.9 TFLOP/s on an H100 SXM (three TF32 products at 494.7 / 3); the
// CUDA cores' 67 TFLOP/s cannot reach it.  TF32 keeps 10 of f32's 23
// mantissa bits, so one TF32 product per pair would round each operand by
// up to 2^-11.  Each operand x is split into hi = x with its low 13 bits
// cleared (exact in TF32) and lo = x - hi (exact in f32, < 2^-10 |x|; the
// tensor core reads its top bits), and each product is three TF32 products,
// lo*hi + hi*lo + hi*hi, summed in f32: what is dropped (lo*lo, and lo's
// bits past TF32) is ~2^-21 relative, as in csrc/flash_attention.cu.
//
// The tensor core's f32 sums truncate: every wgmma rounds its accumulator
// toward zero.  Summed in one accumulator over K, that bias grows with K
// (three wgmmas every 8 columns: 1.0e-5 of max |O| at K = 1024 on an H100,
// 7 times the CUDA cores' error).  So each warpgroup sums runs of four k
// steps (12 wgmmas) in a fresh accumulator and adds each run into a second
// one on the CUDA cores, rounding to nearest: a run's truncations are
// relative to the run's own smaller sum (7.7e-7 at K = 1024, half the CUDA
// cores' error).  The two accumulators take 128 registers, so a warpgroup's
// wgmma is m64n128 (m64n256 without the runs was 10-20 % faster).
//
// Design.  TF32 wgmma reads a shared-memory operand only K-major (the
// transpose bits are for 16-bit types), and B is (K, N) row-major.  So the
// kernel computes O^T = B^T A^T: A's K-major rows are the wgmma's
// shared-memory operand, B^T the register operand, which takes any layout.
// One block per 128 x 128 output tile, three warpgroups:
//
// * Warpgroup 0 feeds shared memory.  Its first thread keeps TMA loads of
//   128 x 32 A tiles (128-byte swizzle; the batch is the map's third
//   dimension, zeros past the ragged M and K edges) in flight through a
//   ring of STAGES slots, each with a "full" mbarrier (bytes landed).  Its
//   other three warps split each landed tile in place: hi over x, lo into
//   the slot's second half at the same offset (the swizzle moves whole
//   16-byte chunks, so an element's place is the same in both), then fence
//   the stores for the async proxy and arrive on the slot's "ready"
//   mbarrier.  The split is an AND and a subtract per element, read once
//   from shared memory; nothing is split, transposed or padded in device
//   memory.
// * Warpgroups 1 and 2 each own 64 of the tile's n columns and its 128 m
//   rows: per 8-deep k step, three wgmma.m64n128k8 TF32 products into 64
//   f32 accumulators a thread, added every four steps into 64 more.  The
//   second warpgroup's runs end two steps after the first's, so that one
//   warpgroup's wait and adds fall while the other's products keep the
//   tensor cores busy.  Their register operand, B^T, is read from device
//   memory straight into registers four k steps ahead (each element of a
//   block's B tile feeds one thread, so it needs no shared memory) and
//   split there.  Row r of a warp's 16 is column 2 (r % 8) + r / 8 of B,
//   so a thread's two columns are adjacent: float2 loads of B and C, and
//   float2 stores of O.  A k step's products are one commit group; the
//   register operand double-buffers across steps, waiting on the group two
//   steps back, which also releases a slot (its "empty" mbarrier) once the
//   last group that read it has completed.
//
// setmaxnreg hands the feeding warpgroup's registers to the consumers (56
// and 224 a thread).  The epilogue loads C, adds it in f32 at the
// accumulators' places and stores what lies inside (M, N).

#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int BM = 128;  // output rows (m) a tile: the wgmma's N
constexpr int BN = 128;  // output columns (n) a tile: 64 a consumer warpgroup
constexpr int BK = 32;   // 128 bytes of f32: one swizzle row
constexpr int KSTEPS = BK / 8;                  // wgmma k steps a slot, and a run
constexpr int STAGES = 4;
constexpr int THREADS = 384;                    // the feeding warpgroup + two consumers
constexpr int SPLITTERS = 96;                   // warps 1-3 of the feeding warpgroup
constexpr int A_BYTES = BM * BK * 4;            // 128 rows x 128 bytes
constexpr int STAGE_BYTES = 2 * A_BYTES;        // hi (in place) and lo
constexpr int FEED_REGS = 56, MMA_REGS = 224;   // 128 * 56 + 256 * 224 <= 65536
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 3 * STAGES * sizeof(uint64_t);
constexpr uint32_t HI_MASK = 0xffffe000u;       // f32 -> TF32 by truncation

struct tf32x3 {};  // names the instantiation in a profile: gemm_kernel<tf32x3>

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & HI_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <typename Tag>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const float* __restrict__ B,
            const float* __restrict__ C, float* __restrict__ O, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  const int ktiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&ready[s], SPLITTERS);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::regs_dealloc<FEED_REGS>();
    if (threadIdx.x == 0) {
      // Slot s of round r is refilled once both consumers have released
      // round r - 1 (the first round passes at once).
      hopper::prefetch_map(&map_a);
      for (int it = 0; it < ktiles; ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], A_BYTES);
        hopper::tma_load_3d(smem + s * STAGE_BYTES, &map_a, &full[s], it * BK, m0, z);
      }
    } else if (threadIdx.x >= 32) {
      const int e0 = threadIdx.x - 32;
      for (int it = 0; it < ktiles; ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        uint4* hi = reinterpret_cast<uint4*>(smem + s * STAGE_BYTES);
        uint4* lo = reinterpret_cast<uint4*>(smem + s * STAGE_BYTES + A_BYTES);
        for (int e = e0; e < A_BYTES / 16; e += SPLITTERS) {
          uint4 h = hi[e], l;
          split(__uint_as_float(h.x), h.x, l.x);
          split(__uint_as_float(h.y), h.y, l.y);
          split(__uint_as_float(h.z), h.z, l.z);
          split(__uint_as_float(h.w), h.w, l.w);
          hi[e] = h;
          lo[e] = l;
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&ready[s]);
      }
    }
  } else {
    hopper::regs_alloc<MMA_REGS>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // This thread's columns n and n + 1 of the tile (rows g and g + 8 of its
    // warp's 16 in O^T); N % 4 == 0, so both lie inside or both outside.
    const int n = n0 + 64 * (wg - 1) + 16 * warp + 2 * g;
    const float* b = n < N ? B + (long long)z * K * N + n : nullptr;
    // B's rows 8q + t4 and 8q + t4 + 4 at this thread's columns, for k step
    // q: a0, a1 and a2, a3 of the wgmma's register operand; zero past K.
    auto load_b = [&](int q, float2 (&r)[2]) {
      const int k = 8 * q + t4;
      const float2 zero = make_float2(0.f, 0.f);
      r[0] = b != nullptr && k < K ? __ldg(reinterpret_cast<const float2*>(b + (long long)k * N))
                                   : zero;
      r[1] = b != nullptr && k + 4 < K
                 ? __ldg(reinterpret_cast<const float2*>(b + (long long)(k + 4) * N))
                 : zero;
    };

    // LAST: the step (of each slot's KSTEPS) after which this warpgroup adds
    // its run.  The second warpgroup's runs end two steps after the first's.
    auto consume = [&](auto last) {
      constexpr int LAST = decltype(last)::value;
      float2 raw[KSTEPS][2];  // B a slot ahead
#pragma unroll
      for (int q = 0; q < KSTEPS; ++q) load_b(q, raw[q]);
      uint32_t hi[2][4], lo[2][4];
      float run[64], sum[64];
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[0][i] = hi[1][i] = lo[0][i] = lo[1][i] = 0u;
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = sum[i] = 0.f;

      for (int it = 0; it < ktiles; ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&ready[s], (it / STAGES) & 1);
        const uint32_t a_hi = hopper::smem_u32(smem + s * STAGE_BYTES);
        const uint32_t a_lo = a_hi + A_BYTES;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int f = kk % 2;  // register operand buffer
          // The group two steps back, the last reader of buffer f, is done;
          // at kk == 1 that is the last group that read the previous slot.
          hopper::wgmma_wait<1>();
          hopper::fence_regs(hi[f]);
          hopper::fence_regs(lo[f]);
          if (kk == 1 && it > 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
          split(raw[kk][0].x, hi[f][0], lo[f][0]);
          split(raw[kk][0].y, hi[f][1], lo[f][1]);
          split(raw[kk][1].x, hi[f][2], lo[f][2]);
          split(raw[kk][1].y, hi[f][3], lo[f][3]);
          load_b((it + 1) * KSTEPS + kk, raw[kk]);
          // A run starts fresh after the step that ends the last one.
          const int fresh = kk == (LAST + 1) % KSTEPS || (kk == 0 && it == 0) ? 0 : 1;
          hopper::wgmma_fence();
          // lo * hi, hi * lo, hi * hi: small terms first.  The kk-th 8
          // columns of K are 32 bytes into each 128-byte row.
          const uint64_t d_hi = hopper::desc_sw128(a_hi + 32 * kk, 16, 1024);
          const uint64_t d_lo = hopper::desc_sw128(a_lo + 32 * kk, 16, 1024);
          hopper::wgmma_rs_tf32_n128(run, lo[f], d_hi, fresh);
          hopper::wgmma_rs_tf32_n128(run, hi[f], d_lo, 1);
          hopper::wgmma_rs_tf32_n128(run, hi[f], d_hi, 1);
          hopper::wgmma_commit();
          if (kk == LAST) {
            hopper::wgmma_wait<0>();
            hopper::fence_regs(run);
#pragma unroll
            for (int i = 0; i < 64; ++i) sum[i] += run[i];
          }
        }
      }
      if constexpr (LAST != KSTEPS - 1) {  // the last run
        hopper::wgmma_wait<0>();
        hopper::fence_regs(run);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += run[i];
      }

      // Epilogue: register 4 j + 2 h + e holds O^T row g + 8 h of the
      // warp's 16 (column n + h of O) and column 8 j + 2 t4 + e (row m).
      // Every load of C is issued before the first store of O.
      if (n < N) {
        float* o = O + (long long)z * M * N + n;
        const float* c = C != nullptr ? C + (long long)z * M * N + n : nullptr;
        float2 add[BM / 8][2];
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + 2 * t4 + e;
            add[j][e] = c != nullptr && m < M
                            ? __ldg(reinterpret_cast<const float2*>(c + (long long)m * N))
                            : make_float2(0.f, 0.f);
          }
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + 2 * t4 + e;
            if (m < M)
              *reinterpret_cast<float2*>(o + (long long)m * N) =
                  make_float2(sum[4 * j + e] + add[j][e].x, sum[4 * j + 2 + e] + add[j][e].y);
          }
      }
    };
    if (wg == 1) consume(std::integral_constant<int, KSTEPS - 1>{});
    else consume(std::integral_constant<int, KSTEPS / 2 - 1>{});
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// f32 only; a, b, c (may be null: no accumulate) and o are (batch, M, K),
// (batch, K, N), (batch, M, N) contiguous, with K % 4 == 0, N % 4 == 0,
// K > 0 and 16-byte aligned bases.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for operands outside that rule, or when the
// tensor map cannot be encoded).
extern "C" int repro_gemm_tf32x3(const void* a, const void* b, const void* c, void* o,
                                 int batch, int M, int N, int K, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 4 || N % 4 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(b) || !aligned16(o) || (c != nullptr && !aligned16(c)))
    return (int)cudaErrorInvalidValue;
  if ((N + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a;
  if (!hopper::map_f32_3d(&map_a, a, K, M, batch, BK, BM)) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_kernel<tf32x3>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batch);
  kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(map_a, (const float*)b, (const float*)c,
                                                        (float*)o, M, N, K);
  return (int)cudaGetLastError();
}
