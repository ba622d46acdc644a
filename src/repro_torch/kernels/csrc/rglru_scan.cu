// RG-LRU linear recurrence, for sm_90a: a single-pass scan over time with
// decoupled look-back.
//
//   h[b, t, w] = a[b, t, w] * h[b, t-1, w] + b[b, t, w],   h[b, -1, w] = 0
//
// a, b, h are (B, S, W), contiguous, f32 or bf16; the recurrence runs in f32
// and h is written in a's type.
//
// Replaces src/repro/kernels/rglru.py:rglru_scan (_rglru_kernel): the same
// function, with the state carried across time segments in f32.
//
// Bound: bytes.  a and b are read once and h written once, 3 * B * S * W
// elements, against 2 * B * S * W flops.
//
// Design.  The TPU kernel walks chunks of time as a sequential grid axis
// and carries the boundary state in VMEM.  Here every (batch row, tile of
// channels, segment of SEG = 128 steps) is a block of its own, each moving
// 32 KB of a and b: 5,120 (f32) or 2,560 (bf16) blocks at the hybrid's wave
// (4, 2048, 2560), where one block per channel tile over all of S gave 320.
// A thread owns VEC neighbouring channels (16 bytes) and a run of 8 steps:
// the CL = 8 lanes of a warp that share a run cover the tile's 8 * VEC
// channels (a 128-byte row), and the warp's 4 runs and the block's 4 warps
// cover the segment.  Tiles are narrow in channels and long in time so that
// one segment holds many tiles (320 f32 or 160 bf16 at the wave): the
// look-back mostly finds its predecessor finished.  (Measured on an H100:
// 64-byte rows were slower, and so were wider tiles, longer runs, 8 warps
// and persistent blocks that prefetch their next tiles.)
//
// A block copies its steps of a and b into shared memory (cp.async, 16
// bytes a thread a step; a thread reads back only what it copied).  Each
// thread scans its run from h = 0 into the pair (prod a, h); the pairs are
// scanned across the warp's runs by shuffles and composed across the warps
// in shared memory into the segment's pair, which warp 0 publishes (flag
// AGGREGATE) before it looks back: it walks the earlier segments of its
// channels, composing their pairs, until it meets one that has published
// its inclusive state (flag INCLUSIVE), which gives the segment's incoming
// state; it then publishes its own inclusive state.  Every thread then
// runs the recurrence over its run from its own incoming state and writes
// h: a and b are read once and h written once; the look-back adds 3 floats
// per channel per segment.  A block takes its tile from an atomic ticket,
// not from blockIdx, so every tile it waits for belongs to a block that
// started before it: the look-back cannot wait on a block that is not
// running.  Flags are written with release and read with acquire
// semantics.  The scratch (ticket counters, flags, pairs, inclusive
// states) is a device buffer the caller keeps between calls: a flag holds
// the call's epoch, so an earlier call's flags read as unpublished and no
// flag is cleared per call; the last block to finish sets the counters
// back to 0.  Steps past S read a = 1, b = 0 and write nothing; channels
// past W are masked, so S and W need not be multiples of anything.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LANES = 32;
constexpr int STEPS = 8;                 // steps a thread
constexpr int WARPS = 4;
constexpr int CL = 8;                    // lanes (channel vectors) a tile row
constexpr unsigned AGGREGATE = 1, INCLUSIVE = 2;

// Channels a thread (16 bytes), channels a tile, runs a warp, steps a tile.
template <typename T> struct Geo {
  static constexpr int N = 16 / sizeof(T), TILE_W = CL * N, G = LANES / CL,
                       SEG = WARPS * G * STEPS;
};

template <typename T> struct alignas(16) Pack { T v[Geo<T>::N]; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(LANES * WARPS, 5)
rglru_kernel(const T* __restrict__ A, const T* __restrict__ Bv, T* __restrict__ H, int B,
             int S, int W, int tiles_w, unsigned* __restrict__ counters,
             unsigned* __restrict__ flags, float* __restrict__ agg, float* __restrict__ incl,
             unsigned epoch) {
  using G_ = Geo<T>;
  constexpr int N = G_::N, TILE_W = G_::TILE_W, G = G_::G, SEG = G_::SEG;
  constexpr int THREADS = LANES * WARPS;
  __shared__ int4 data[2][STEPS][THREADS];  // a, b: this block's steps, as Pack<T>
  __shared__ float warp_a[WARPS][N][CL], warp_h[WARPS][N][CL], h_in[N][CL];
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x, lane = tid % LANES, warp = tid / LANES;
  const int cv = lane % CL, g = lane / CL;  // channel vector, run within the warp
  if (tid == 0) s_ticket = atomicAdd(counters, 1u);
  __syncthreads();
  const unsigned ticket = s_ticket;
  const unsigned per_seg = (unsigned)B * tiles_w;  // tiles of one segment
  const int seg = ticket / per_seg;
  const int rem = ticket % per_seg;
  const int c = (rem % tiles_w) * TILE_W + cv * N;  // this thread's first channel
  const int live_ch = W - c;
  const int t0 = seg * SEG + (warp * G + g) * STEPS;
  const long long base = (long long)(rem / tiles_w) * S * W + c;

  // This thread's steps of a and b into its own slots (zero past S and W).
  Pack<T>* da = reinterpret_cast<Pack<T>*>(&data[0][0][tid]);
  Pack<T>* db = reinterpret_cast<Pack<T>*>(&data[1][0][tid]);
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const bool live_t = t0 + j < S;
    const long long off = base + (long long)(t0 + j) * W;
    if (VECTOR) {
      const bool live = live_t && live_ch >= N;
      cp_async16(da + j * THREADS, live ? A + off : A, live ? 16 : 0);
      cp_async16(db + j * THREADS, live ? Bv + off : Bv, live ? 16 : 0);
    } else {
      Pack<T> a, b;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const bool live = live_t && i < live_ch;
        a.v[i] = live ? A[off + i] : from_f32<T>(0.f);
        b.v[i] = live ? Bv[off + i] : from_f32<T>(0.f);
      }
      da[j * THREADS] = a;
      db[j * THREADS] = b;
    }
  }
  cp_async_commit();
  cp_async_wait_all();

  // The run's pair from h = 0: h -> pa * h + ph over its steps.
  float pa[N], ph[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    pa[i] = 1.f;
    ph[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (t0 + j >= S) break;
    const Pack<T> a = da[j * THREADS], b = db[j * THREADS];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float x = to_f32(a.v[i]);
      ph[i] = fmaf(x, ph[i], to_f32(b.v[i]));
      pa[i] *= x;
    }
  }
  // Inclusive scan of the pairs over the warp's runs (lanes CL apart), then
  // each run's exclusive prefix (ea, eh).
#pragma unroll
  for (int d = 1; d < G; d *= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float oa = __shfl_up_sync(0xffffffffu, pa[i], CL * d);
      const float oh = __shfl_up_sync(0xffffffffu, ph[i], CL * d);
      if (g >= d) {
        ph[i] = fmaf(pa[i], oh, ph[i]);
        pa[i] *= oa;
      }
    }
  }
  float ea[N], eh[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ea[i] = __shfl_up_sync(0xffffffffu, pa[i], CL);
    eh[i] = __shfl_up_sync(0xffffffffu, ph[i], CL);
    if (g == 0) {
      ea[i] = 1.f;
      eh[i] = 0.f;
    }
    if (g == G - 1) {
      warp_a[warp][i][cv] = pa[i];
      warp_h[warp][i][cv] = ph[i];
    }
  }
  __syncthreads();

  if (warp == 0 && g == 0) {
    // The segment's pair (composed from the warps' pairs in shared memory
    // where it is needed, to keep registers free), then its incoming state
    // by look-back.
    auto seg_pair = [&](int i, float& sa, float& sh) {
      sa = 1.f;
      sh = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sh = fmaf(warp_a[w][i][cv], sh, warp_h[w][i][cv]);
        sa *= warp_a[w][i][cv];
      }
    };
    float hin[N];
#pragma unroll
    for (int i = 0; i < N; ++i) hin[i] = 0.f;
    const long long slot = (long long)ticket * CL + cv;
    if (seg > 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) seg_pair(i, agg[slot * 2 * N + i], agg[slot * 2 * N + N + i]);
      st_release(flags + slot, epoch * 4 + AGGREGATE);
      // Walk back: (ta, th) composes the segments between the one read and
      // this one; an inclusive state ends the walk.
      float ta[N], th[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        ta[i] = 1.f;
        th[i] = 0.f;
      }
      long long prev = slot - (long long)per_seg * CL;
      while (true) {
        unsigned f;
        do {
          f = ld_acquire(flags + prev);
        } while (f != epoch * 4 + AGGREGATE && f != epoch * 4 + INCLUSIVE);
        if (f == epoch * 4 + INCLUSIVE) {
#pragma unroll
          for (int i = 0; i < N; ++i) hin[i] = fmaf(ta[i], __ldcg(incl + prev * N + i), th[i]);
          break;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          th[i] = fmaf(ta[i], __ldcg(agg + prev * 2 * N + N + i), th[i]);
          ta[i] *= __ldcg(agg + prev * 2 * N + i);
        }
        prev -= (long long)per_seg * CL;  // segment 0 is always inclusive
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float sa, sh;
      seg_pair(i, sa, sh);
      incl[slot * N + i] = fmaf(sa, hin[i], sh);
      h_in[i][cv] = hin[i];
    }
    st_release(flags + slot, epoch * 4 + INCLUSIVE);
  }
  __syncthreads();

  // The recurrence over this run from its incoming state: the segment's,
  // carried through the warps and the runs before it.
  float h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    h[i] = h_in[i][cv];
    for (int w = 0; w < warp; ++w) h[i] = fmaf(warp_a[w][i][cv], h[i], warp_h[w][i][cv]);
    h[i] = fmaf(ea[i], h[i], eh[i]);
  }
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (t0 + j >= S || live_ch <= 0) break;
    const Pack<T> a = da[j * THREADS], b = db[j * THREADS];
    Pack<T> out;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      h[i] = fmaf(to_f32(a.v[i]), h[i], to_f32(b.v[i]));
      out.v[i] = from_f32<T>(h[i]);
    }
    T* p = H + base + (long long)(t0 + j) * W;
    if (VECTOR && live_ch >= N) {
      *reinterpret_cast<Pack<T>*>(p) = out;
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < live_ch) p[i] = out.v[i];
    }
  }
  // The last block to finish (every block has taken its ticket by then)
  // sets both counters back to 0 for the next call.
  if (tid == 0 && atomicAdd(counters + 1, 1u) == gridDim.x - 1) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

template <typename T>
long long scratch_words(int B, int S, int W) {
  constexpr int N = Geo<T>::N, TILE_W = Geo<T>::TILE_W, SEG = Geo<T>::SEG;
  const long long tiles = (long long)((S + SEG - 1) / SEG) * B * ((W + TILE_W - 1) / TILE_W);
  return 4 + tiles * CL * (1 + 3 * N);  // counters (padded), flags, pairs, inclusive states
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W, void* scratch,
           long long words, unsigned epoch, void* stream) {
  constexpr int N = Geo<T>::N, TILE_W = Geo<T>::TILE_W, SEG = Geo<T>::SEG;
  if (words < scratch_words<T>(B, S, W)) return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const long long tiles = (long long)((S + SEG - 1) / SEG) * B * tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unsigned* counters = (unsigned*)scratch;
  unsigned* flags = counters + 4;
  float* agg = (float*)(flags + tiles * CL);
  float* incl = agg + tiles * CL * 2 * N;
  const bool vector = W % N == 0 && ((uintptr_t)a | (uintptr_t)b | (uintptr_t)h) % 16 == 0;
  auto kernel = vector ? rglru_kernel<T, true> : rglru_kernel<T, false>;
  kernel<<<(unsigned)tiles, LANES * WARPS, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (T*)h, B, S, W, tiles_w, counters, flags, agg, incl, epoch);
  return (int)cudaGetLastError();
}

}  // namespace

// The int32 words of scratch a call at (dtype, B, S, W) needs.
extern "C" long long repro_rglru_scan_scratch(int dtype, int B, int S, int W) {
  return dtype == 1 ? scratch_words<__nv_bfloat16>(B, S, W) : scratch_words<float>(B, S, W);
}

// dtype: 0 = float32, 1 = bfloat16.  a, b, h: (B, S, W) contiguous, all of
// one type.  scratch: `words` int32 words of device memory kept between
// calls on one stream, zeroed once (each call leaves its counters at 0);
// epoch is in [1, 2^30) and differs from the previous call's on that
// scratch.  Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan(const void* a, const void* b, void* h, int dtype, int B,
                                int S, int W, void* scratch, long long words, unsigned epoch,
                                void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  if (epoch == 0 || epoch >= (1u << 30)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(a, b, h, B, S, W, scratch, words, epoch, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h, B, S, W, scratch, words, epoch, stream);
  return (int)cudaErrorInvalidValue;
}
