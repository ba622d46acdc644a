// Batched bf16 GEMM on the tensor cores, with the accumulate-into-output
// epilogue, for sm_90a.
//
//   O[z] = A[z] @ B[z]            (C == nullptr)
//   O[z] = C[z] + A[z] @ B[z]     (accumulate)
//
// The tensor-core route of src/repro/kernels/gemm.py:_gemm_kernel (the DCA
// analogue); csrc/gemm.cu keeps the f32 calls and the bf16 shapes that TMA
// cannot address.  A (M, K), B (K, N), C and O (M, N) are bf16, row-major
// and contiguous inside each batch member, with K % 8 == 0, N % 8 == 0 and
// 16-byte aligned bases (every TMA row stride is then a multiple of 16
// bytes).  A bf16 x bf16 product is exact in f32 and wgmma sums in f32, so
// the numbers are the reference's: f32 products and sums, C added in f32,
// one rounding to bf16.
//
// Bound: bf16 tensor-core operations, 2 M N K per member.  Design: one block
// per 128 x 128 output tile, three warpgroups.  Warpgroup 0 is the producer:
// one thread keeps TMA loads of 64-deep A and B tiles in flight through a
// ring of STAGES slots in shared memory (128-byte swizzle), each with a
// "full" mbarrier (bytes landed) and an "empty" one (both consumers done).
// Warpgroups 1 and 2 are the consumers: each issues
// wgmma.m64n128k16.f32.bf16.bf16 on its 64 rows of the tile, A read K-major
// and B read MN-major straight from its (K, N) rows through the transpose-B
// bit, so no transposed copy is made.  The batch is the third dimension of
// the 3-D tensor maps (blockIdx.z), so one launch covers every member of a
// stacked mesh; TMA writes zeros past the ragged M, N and K edges.  The
// epilogue adds C at the accumulator fragments' positions, rounds to bf16
// and stores what lies inside (M, N).

#include "hopper.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;  // 128 bytes of bf16: one swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                    // warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;            // 128 rows x 128 bytes
constexpr int B_BYTES = BK * BN * 2;            // two boxes of 64 K-rows x 64 columns
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ C,
                  bf16* __restrict__ O, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const int ktiles = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: slot s of round r is refilled once both consumers have
    // released round r - 1 (the first round passes at once).
    if (tid == 0) {
      hopper::prefetch_map(&map_a);
      hopper::prefetch_map(&map_b);
      for (int it = 0; it < ktiles; ++it) {
        const int s = it % STAGES;
        const uint32_t round = it / STAGES;
        hopper::mbar_wait(&empty[s], (round & 1) ^ 1);
        uint8_t* a = smem + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        hopper::tma_load_3d(a, &map_a, &full[s], it * BK, m0, z);
        hopper::tma_load_3d(b, &map_b, &full[s], n0, it * BK, z);
        hopper::tma_load_3d(b + B_BYTES / 2, &map_b, &full[s], n0 + 64, it * BK, z);
      }
    }
  } else {
    const int w = wg - 1;  // this consumer's 64 rows of the tile
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int it = 0; it < ktiles; ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a = hopper::smem_u32(smem + s * STAGE_BYTES) + w * 64 * 128;
      const uint32_t b = hopper::smem_u32(smem + s * STAGE_BYTES + A_BYTES);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A K-major: the kk-th 16 columns are 32 bytes into each row.
        // B MN-major: the kk-th 16 K-rows are 2048 bytes on; its two
        // 64-column boxes lie B_BYTES / 2 apart.
        hopper::wgmma_ss_n128<1>(acc, hopper::desc_sw128(a + 32 * kk, 16, 1024),
                                 hopper::desc_sw128(b + 2048 * kk, B_BYTES / 2, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: register 4 j + 2 h + e holds row (warp rows) + 8 h and
    // column 8 j + 2 (lane % 4) + e.  N is even, so a pair is in or out.
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = m0 + w * 64 + warp * 16 + lane / 4;
    const long long zoff = (long long)z * M * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M || col >= N) continue;
        const long long o = zoff + (long long)row * N + col;
        float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        if (C != nullptr) {
          const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(C + o);
          x0 += __low2float(c);
          x1 += __high2float(c);
        }
        *reinterpret_cast<__nv_bfloat162*>(O + o) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// bf16 only; a, b, c (may be null: no accumulate) and o are (batch, M, K),
// (batch, K, N), (batch, M, N) contiguous, with K % 8 == 0, N % 8 == 0,
// K > 0 and 16-byte aligned bases.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for operands outside that rule, or when the
// tensor maps cannot be encoded).
extern "C" int repro_gemm_wgmma(const void* a, const void* b, const void* c, void* o, int batch,
                                int M, int N, int K, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(b) || !aligned16(o) || (c != nullptr && !aligned16(c)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!hopper::map_bf16_3d(&map_a, a, K, M, batch, 64, BM) ||
      !hopper::map_bf16_3d(&map_b, b, N, K, batch, 64, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_wgmma_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      map_a, map_b, (const bf16*)c, (bf16*)o, M, N, K);
  return (int)cudaGetLastError();
}
