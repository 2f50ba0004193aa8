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
// row runs in another order than the reference's, which moves the mean by a
// few f32 ulps at most.  rsqrt is 1 / sqrtf (both correctly rounded without
// fast math).
//
// What bounds it.  One read of x, one of w, one write of y: at (32768, 960)
// in bf16 that is 126 MB, 37.6 us at 3.35 TB/s; at (32768, 6144), 805 MB,
// 240 us.  Its 3 flops per element are nothing beside that: it is bound by
// bytes.
//
// What the design does about it, simply: one block of 256 threads per row,
// any D.  Threads stride over the row (neighbouring threads on neighbouring
// elements, so loads and stores coalesce), sum their squares, reduce
// through warp shuffles and one shared-memory step, then read the row again
// (from L1/L2: a 12 KB row at D = 6144 in bf16) to scale and store it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block (one row)
constexpr int NWARP = NT / 32;

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

template <int XF, int WF>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const typename Fmt<XF>::T* __restrict__ x,
               const typename Fmt<WF>::T* __restrict__ w,
               typename Fmt<XF>::T* __restrict__ y, int D, float eps) {
  using FX = Fmt<XF>;
  using FW = Fmt<WF>;
  __shared__ float part[NWARP];
  __shared__ float scale;

  const size_t row = blockIdx.x;
  const typename FX::T* xr = x + row * D;
  typename FX::T* yr = y + row * D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  float s = 0.f;
  for (int d = tid; d < D; d += NT) {
    const float v = FX::ld(xr[d]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int k = 0; k < NWARP; ++k) total += part[k];
    scale = 1.f / sqrtf(total / static_cast<float>(D) + eps);
  }
  __syncthreads();

  const float r = scale;
  for (int d = tid; d < D; d += NT) {
    const float v = FX::ld(xr[d]);
    yr[d] = FX::st(__fmul_rn(__fmul_rn(v, r), FW::ld(w[d])));
  }
}

template <int XF, int WF>
int launch(const void* x, const void* w, void* y, int N, int D, float eps,
           cudaStream_t stream) {
  rmsnorm_kernel<XF, WF><<<N, NT, 0, stream>>>(
      static_cast<const typename Fmt<XF>::T*>(x), static_cast<const typename Fmt<WF>::T*>(w),
      static_cast<typename Fmt<XF>::T*>(y), D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int XF>
int dispatch_w(const void* x, const void* w, void* y, int N, int D, int wfmt, float eps,
               cudaStream_t stream) {
  switch (wfmt) {
    case FMT_F32:
      return launch<XF, FMT_F32>(x, w, y, N, D, eps, stream);
    case FMT_BF16:
      return launch<XF, FMT_BF16>(x, w, y, N, D, eps, stream);
    case FMT_F16:
      return launch<XF, FMT_F16>(x, w, y, N, D, eps, stream);
  }
  return -1;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, allocates nothing,
// and returns cudaGetLastError(), or -1 for an unknown format code.  N >= 1.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int N, int D, int xfmt,
                           int wfmt, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (xfmt) {
    case FMT_F32:
      return dispatch_w<FMT_F32>(x, w, y, N, D, wfmt, eps, s);
    case FMT_BF16:
      return dispatch_w<FMT_BF16>(x, w, y, N, D, wfmt, eps, s);
    case FMT_F16:
      return dispatch_w<FMT_F16>(x, w, y, N, D, wfmt, eps, s);
  }
  return -1;
}
