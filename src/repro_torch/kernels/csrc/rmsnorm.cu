// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rmsnorm_kernel` in src/repro/kernels/rmsnorm.py
// (reached through `repro.kernels.ops.rmsnorm`).  For every row n of x (N, D)
//
//     y[n, d] = (x[n, d] * rsqrt(mean_d(x[n, d]^2) + eps)) * w[d]
//
// with x and w read as f32 (each of f32, bf16 or fp16, independently), the
// squares, their sum, the mean and both products in f32, and y rounded once
// to x's dtype at the store, as the reference's kernel computes it.  The
// squares and products are rounded one at a time (__fmul_rn, no contraction
// into an FMA), as the reference's elementwise f32 ops are; the sum over the
// row runs in another order than the reference's (fixed: each thread's
// elements in turn, then a warp's shuffle tree, then the row's warps in
// order), which moves the mean by a few f32 ulps at most.  rsqrt is
// 1 / sqrtf (both correctly rounded without fast math).
//
// What bounds it.  One read of x, one of w, one write of y: at (32768, 960)
// in bf16 that is 126 MB, 37.6 us at 3.35 TB/s; at (32768, 6144), 805 MB,
// 240 us.  Its 3 flops per element are nothing beside that: it is bound by
// bytes.
//
// What the design does about it.  A row is read from device memory once and
// held in registers between its sum and its scaling.  A group of `wpr`
// warps takes a row: one warp while its lanes hold the row in at most 4
// 16-byte loads each (1024 bf16 or 512 f32 features), then 2, 4 or 8
// warps, with 8 loads a lane only at 8 warps.  A block of 8 warps takes
// 8 / wpr rows at a time, and the grid walks the row groups (`waves`
// times as many blocks as are resident on the card, or a block a row
// group).  Each lane owns the same columns of every row it takes, so it
// loads its part of w once into registers, and (up to 4 loads a lane) its
// part of its next row before it sums and stores the current one.  Loads
// and stores move 16 bytes a lane (8 bf16/fp16 or 4 f32 elements)
// wherever the row's bytes are a multiple of 16 and x, w and y start on
// 16 bytes; otherwise one element a lane.  A warp's sum reduces through
// shuffles; a row of several warps adds their partial sums through shared
// memory after one __syncthreads (two buffers alternate between row
// groups, so no second barrier is needed).  Rows wider than 8 warps'
// registers hold (CH = 0, the generic instance: past 16384 bf16 or 8192
// f32 features with 16-byte loads, 2048 without) read the row a second
// time for the scaling, from L1/L2.  The host (`rmsnorm_plan` in
// kernels/rmsnorm.py) picks the loads' width, the loads a lane holds, the
// warps a row takes and the waves.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;
// instances of up to this many packs a lane load their part of the next
// row they take before they sum and store the current one; more would cost
// occupancy (`tools/kernel_trials.py` times 0 and 8)
constexpr int PREFETCH_MAX_CH = 4;

enum { FMT_F32 = 0, FMT_BF16 = 1, FMT_F16 = 2 };

template <int FMT>
struct Fmt;

template <>
struct Fmt<FMT_F32> {
  using T = float;
  __device__ static float ld(T v) { return v; }
  __device__ static T st(float v) { return v; }
};

template <>
struct Fmt<FMT_BF16> {
  using T = __nv_bfloat16;
  __device__ static float ld(T v) { return __bfloat162float(v); }
  __device__ static T st(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Fmt<FMT_F16> {
  using T = __half;
  __device__ static float ld(T v) { return __half2float(v); }
  __device__ static T st(float v) { return __float2half_rn(v); }
};

// V consecutive elements, moved as one access of up to 16 bytes (a 32-byte
// pack, 8 f32 of w beside 8 halves of x, as two)
template <typename T, int V>
struct alignas(V * sizeof(T) < 16 ? V * sizeof(T) : 16) Pack {
  T v[V];
};

// The row group's sum of `s` over its warps: shuffles, then (wpr > 1) the
// warps' partial sums through shared memory, in warp order.
__device__ __forceinline__ float row_sum(float s, int wpr, int grp, int lane, int warp,
                                         float (*part)[NWARP], int parity) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (wpr == 1) return s;
  if (lane == 0) part[parity][warp] = s;
  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < wpr; ++k) t += part[parity][grp * wpr + k];
  return t;
}

// Block of 8 warps; a row takes `wpr` warps; a lane holds CH packs of V
// elements of its row (CH = 0: none, the row is read twice).
template <int XF, int WF, int V, int CH>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const typename Fmt<XF>::T* __restrict__ x,
               const typename Fmt<WF>::T* __restrict__ w,
               typename Fmt<XF>::T* __restrict__ y, int N, int D, int wpr, float eps) {
  using FX = Fmt<XF>;
  using FW = Fmt<WF>;
  using PX = Pack<typename FX::T, V>;
  using PW = Pack<typename FW::T, V>;
  constexpr bool PREFETCH = CH > 0 && CH <= PREFETCH_MAX_CH;
  __shared__ float part[2][NWARP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = 32 * wpr, rpb = NWARP / wpr;
  const int grp = warp / wpr, gt = tid - grp * G;
  const int units = D / V;   // V > 1 only where V divides D
  const float inv_d = 1.f / static_cast<float>(D);

  PW wv[CH > 0 ? CH : 1];
  if constexpr (CH > 0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = c * G + gt;
      if (u < units) wv[c] = reinterpret_cast<const PW*>(w)[u];
    }
  }

  const long long stride = static_cast<long long>(gridDim.x) * rpb;
  // the lane's packs of `row`, where the row exists
  auto load_row = [&](PX* dst, long long row) {
    if (row >= N) return;
    const PX* src = reinterpret_cast<const PX*>(x + row * D);
#pragma unroll
    for (int c = 0; c < (CH > 0 ? CH : 1); ++c) {
      const int u = c * G + gt;
      if (u < units) dst[c] = src[u];
    }
  };
  PX xv[CH > 0 ? CH : 1], xn[PREFETCH ? CH : 1];
  if constexpr (PREFETCH) load_row(xv, static_cast<long long>(blockIdx.x) * rpb + grp);

  int parity = 0;
  for (long long row0 = static_cast<long long>(blockIdx.x) * rpb; row0 < N;
       row0 += stride, parity ^= 1) {
    const long long row = row0 + grp;
    const bool live = row < N;
    const PX* xr = reinterpret_cast<const PX*>(x + (live ? row : 0) * D);
    PX* yr = reinterpret_cast<PX*>(y + (live ? row : 0) * D);
    float s = 0.f;
    if constexpr (CH > 0) {
      if constexpr (PREFETCH) {
        load_row(xn, row + stride);
      } else {
        load_row(xv, row);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (live && c * G + gt < units) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float v = FX::ld(xv[c].v[e]);
            s = __fadd_rn(s, __fmul_rn(v, v));
          }
        }
      }
      const float r = 1.f / sqrtf(row_sum(s, wpr, grp, lane, warp, part, parity) * inv_d + eps);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int u = c * G + gt;
        if (live && u < units) {
          PX o;
#pragma unroll
          for (int e = 0; e < V; ++e)
            o.v[e] = FX::st(__fmul_rn(__fmul_rn(FX::ld(xv[c].v[e]), r), FW::ld(wv[c].v[e])));
          yr[u] = o;
        }
      }
      if constexpr (PREFETCH) {
#pragma unroll
        for (int c = 0; c < CH; ++c) xv[c] = xn[c];
      }
    } else {
      for (int u = gt; live && u < units; u += G) {
        const PX p = xr[u];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = FX::ld(p.v[e]);
          s = __fadd_rn(s, __fmul_rn(v, v));
        }
      }
      const float r = 1.f / sqrtf(row_sum(s, wpr, grp, lane, warp, part, parity) * inv_d + eps);
      for (int u = gt; live && u < units; u += G) {
        const PX p = xr[u];
        const PW q = reinterpret_cast<const PW*>(w)[u];
        PX o;
#pragma unroll
        for (int e = 0; e < V; ++e)
          o.v[e] = FX::st(__fmul_rn(__fmul_rn(FX::ld(p.v[e]), r), FW::ld(q.v[e])));
        yr[u] = o;
      }
    }
  }
}

template <int XF, int WF, int V, int CH>
int launch(const void* x, const void* w, void* y, int N, int D, int wpr, int waves, float eps,
           cudaStream_t stream) {
  auto* kernel = rmsnorm_kernel<XF, WF, V, CH>;
  // the blocks resident on the card at once: the grid walks the rows
  static int per_sm = 0;
  static const cudaError_t queried =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  if (queried != cudaSuccess) return static_cast<int>(queried);
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return -2;
  // `waves` times the resident blocks walk the row groups; 0: a block each
  const long long groups = (static_cast<long long>(N) + NWARP / wpr - 1) / (NWARP / wpr);
  const long long most = waves > 0 ? 1LL * sms * per_sm * waves : groups;
  const int grid = static_cast<int>(groups < most ? groups : most);
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const typename Fmt<XF>::T*>(x), static_cast<const typename Fmt<WF>::T*>(w),
      static_cast<typename Fmt<XF>::T*>(y), N, D, wpr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int XF, int WF>
int dispatch_plan(const void* x, const void* w, void* y, int N, int D, int vec, int chunks,
                  int wpr, int waves, float eps, cudaStream_t stream) {
  constexpr int VX = 16 / sizeof(typename Fmt<XF>::T);
  if ((wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) || waves < 0) return -2;
  if (vec) {
    // 16-byte packs need 16-byte rows and operands
    if ((static_cast<long long>(D) * sizeof(typename Fmt<XF>::T)) % 16 != 0) return -2;
    for (const void* p : {x, w, static_cast<const void*>(y)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -2;
  }
  const long long held = 32LL * wpr * chunks * (vec ? VX : 1);
  if (chunks != 0 && held < D) return -2;
  switch (vec * 16 + chunks) {
    case 2: return launch<XF, WF, 1, 2>(x, w, y, N, D, wpr, waves, eps, stream);
    case 4: return launch<XF, WF, 1, 4>(x, w, y, N, D, wpr, waves, eps, stream);
    case 8: return launch<XF, WF, 1, 8>(x, w, y, N, D, wpr, waves, eps, stream);
    case 0:
      return wpr == 8 ? launch<XF, WF, 1, 0>(x, w, y, N, D, wpr, waves, eps, stream) : -2;
    case 18: return launch<XF, WF, VX, 2>(x, w, y, N, D, wpr, waves, eps, stream);
    case 20: return launch<XF, WF, VX, 4>(x, w, y, N, D, wpr, waves, eps, stream);
    case 24: return launch<XF, WF, VX, 8>(x, w, y, N, D, wpr, waves, eps, stream);
  }
  return -2;
}

template <int XF>
int dispatch_w(const void* x, const void* w, void* y, int N, int D, int wfmt, int vec,
               int chunks, int wpr, int waves, float eps, cudaStream_t stream) {
  switch (wfmt) {
    case FMT_F32:
      return dispatch_plan<XF, FMT_F32>(x, w, y, N, D, vec, chunks, wpr, waves, eps, stream);
    case FMT_BF16:
      return dispatch_plan<XF, FMT_BF16>(x, w, y, N, D, vec, chunks, wpr, waves, eps, stream);
    case FMT_F16:
      return dispatch_plan<XF, FMT_F16>(x, w, y, N, D, vec, chunks, wpr, waves, eps, stream);
  }
  return -1;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError(), -1 for an unknown format code, or -2 for
// a plan the kernel does not take: `vec` (16-byte packs) with a row or an
// operand off 16 bytes, `wpr` warps a row not 1, 2, 4 or 8, `chunks` packs
// a lane not 2, 4 or 8 or too few for D, or 0 (the generic instance) with
// other than 8 warps a row or with `vec`, or `waves` below 0; or a CUDA
// error of the occupancy query.  `waves` times as many blocks as are
// resident on the card walk the row groups (0: one block a row group).
// N >= 1.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int N, int D, int xfmt,
                           int wfmt, int vec, int chunks, int wpr, int waves, float eps,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (xfmt) {
    case FMT_F32:
      return dispatch_w<FMT_F32>(x, w, y, N, D, wfmt, vec, chunks, wpr, waves, eps, s);
    case FMT_BF16:
      return dispatch_w<FMT_BF16>(x, w, y, N, D, wfmt, vec, chunks, wpr, waves, eps, s);
    case FMT_F16:
      return dispatch_w<FMT_F16>(x, w, y, N, D, wfmt, vec, chunks, wpr, waves, eps, s);
  }
  return -1;
}
