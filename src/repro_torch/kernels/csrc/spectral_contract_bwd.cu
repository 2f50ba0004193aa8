// Dense spectral contraction, the two backward kernels, for Hopper (sm_90a).
//
// Replace the TPU kernels `_dense_bwd_x_kernel` and `_dense_bwd_w_kernel`
// in src/repro/kernels/spectral_contract.py (reached through the custom
// VJP `_dense_op_bwd`).  For every retained Fourier mode m, with the
// forward out[b,o,m] = sum_i x[b,i,m] * w[i,o,m] and its cotangent g:
//
//     dx[b,i,m] = sum_o g[b,o,m] * conj(w[i,o,m])       (dense_bwd_x)
//     dw[i,o,m] = sum_b conj(x[b,i,m]) * g[b,o,m]       (dense_bwd_w)
//
// in split-real form:
//     dxr = sum_o gr*wr + gi*wi      dxi = sum_o gi*wr - gr*wi
//     dwr = sum_b xr*gr + xi*gi      dwi = sum_b xr*gi - xi*gr
//
// x and w are the forward's unrounded f32 operands.  CAST rounds every
// operand, g included, onto the bf16 or fp16 grid (round to nearest even)
// before use, as the reference's `_cast_tiles`; sums are f32 and both
// gradients are stored at f32, the primal dtype.  The gradient itself is
// never rounded to the half grid.
//
// The cotangent g is read at the dtype it is stored in (G: f32, bf16 or
// fp16), which is the forward's out_dtype.  Under a half rule that halves
// g's bytes and spares a separate upcast pass (a launch plus a write and a
// read of the f32 copy); the conversion costs one instruction per load.
// Rounding a bf16 g onto the bf16 grid is then exact, as in the reference.
//
// What bounds them.  At the training path's shape (B=8, I=O=64, M=1024,
// bf16 g) each kernel moves 39.8 MB: dense_bwd_x reads w 33.6 MB and g
// 2.1 MB and writes dx 4.2 MB; dense_bwd_w reads x 4.2 MB and g 2.1 MB and
// writes dw 33.6 MB.  That is 11.9 us at 3.35 TB/s against 4.0 us for the
// 268 MFLOP on the f32 cores: both are memory-bound, and the (I, O, M)
// weight or weight-gradient stream is 84 % of the bytes.
//
// What the design does about it.  dense_bwd_x is the forward kernel with
// the roles of I and O swapped: a thread owns one (i, m) and BT complex
// batch accumulators, reads each w element once (for B <= BT), coalesced
// along M, and the g values of its block are staged in shared memory one
// chunk of OC output channels at a time.  dense_bwd_w writes each dw
// element once, coalesced along M: a thread owns one (i, m) and TO output
// channels of it, and loops over the batch in chunks of BT whose x and g
// tiles are staged in shared memory, so x[b,i,m] is reused across o and
// g[b,o,m] across i.  Neither kernel uses atomics: every output is reduced
// by one thread in a fixed order, so a rerun is bit-identical.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;  // modes per block: one warp along M
constexpr int TY = 8;   // threadIdx.y: input channels per block
constexpr int BT = 8;   // batch rows per pass
constexpr int OC = 16;  // output channels staged per pass (dense_bwd_x)
constexpr int TO = 8;   // output channels per thread (dense_bwd_w)

enum { FMT_F32 = 0, FMT_BF16 = 1, FMT_F16 = 2 };

template <int FMT>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (FMT == FMT_BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (FMT == FMT_F16) {
    return __half2float(__float2half_rn(v));
  } else {
    return v;
  }
}

template <int FMT>
struct Load;

template <>
struct Load<FMT_F32> {
  using T = float;
  __device__ static float cvt(T v) { return v; }
};

template <>
struct Load<FMT_BF16> {
  using T = __nv_bfloat16;
  __device__ static float cvt(T v) { return __bfloat162float(v); }
};

template <>
struct Load<FMT_F16> {
  using T = __half;
  __device__ static float cvt(T v) { return __half2float(v); }
};

// dx[b,i,m] = sum_o g[b,o,m] * conj(w[i,o,m]).  Block (TM, TY): modes
// m0..m0+TM of input channels i0..i0+TY, batch rows b0..b0+BT.
template <int CAST, int G>
__global__ void __launch_bounds__(TM * TY)
dense_bwd_x_kernel(const typename Load<G>::T* __restrict__ gr,
                   const typename Load<G>::T* __restrict__ gi,
                   const float* __restrict__ wr, const float* __restrict__ wi,
                   float* __restrict__ dxr, float* __restrict__ dxi,
                   int B, int I, int O, int M) {
  __shared__ float sgr[OC][BT][TM];
  __shared__ float sgi[OC][BT][TM];

  const int tx = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int m = m0 + tx;
  const int i = blockIdx.y * TY + threadIdx.y;
  const int b0 = blockIdx.z * BT;
  const bool live = (m < M) && (i < I);
  const int tid = threadIdx.y * TM + tx;

  float accr[BT], acci[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    accr[b] = 0.f;
    acci[b] = 0.f;
  }

  for (int o0 = 0; o0 < O; o0 += OC) {
    // this thread's weights for the chunk, issued before the g staging so
    // the loads overlap it
    float wrv[OC], wiv[OC];
#pragma unroll
    for (int k = 0; k < OC; ++k) {
      wrv[k] = 0.f;
      wiv[k] = 0.f;
      if (live && o0 + k < O) {
        const size_t off = (static_cast<size_t>(i) * O + o0 + k) * M + m;
        wrv[k] = round_to<CAST>(wr[off]);
        wiv[k] = round_to<CAST>(wi[off]);
      }
    }
    // stage g[b0:b0+BT, o0:o0+OC, m0:m0+TM], zero outside the tensor
    for (int t = tid; t < OC * BT * TM; t += TM * TY) {
      const int mm = t % TM;
      const int bb = (t / TM) % BT;
      const int oo = t / (TM * BT);
      const int gm = m0 + mm, gb = b0 + bb, go = o0 + oo;
      float vr = 0.f, vi = 0.f;
      if (gm < M && gb < B && go < O) {
        const size_t off = (static_cast<size_t>(gb) * O + go) * M + gm;
        vr = round_to<CAST>(Load<G>::cvt(gr[off]));
        vi = round_to<CAST>(Load<G>::cvt(gi[off]));
      }
      sgr[oo][bb][mm] = vr;
      sgi[oo][bb][mm] = vi;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < OC; ++k) {
      const float a = wrv[k], c = wiv[k];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float p = sgr[k][b][tx], q = sgi[k][b][tx];
        accr[b] = fmaf(p, a, accr[b]);
        accr[b] = fmaf(q, c, accr[b]);
        acci[b] = fmaf(q, a, acci[b]);
        acci[b] = fmaf(-p, c, acci[b]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b0 + b < B) {
      const size_t off = (static_cast<size_t>(b0 + b) * I + i) * M + m;
      dxr[off] = accr[b];
      dxi[off] = acci[b];
    }
  }
}

// dw[i,o,m] = sum_b conj(x[b,i,m]) * g[b,o,m].  Block (TM, TY): modes
// m0..m0+TM of input channels i0..i0+TY and output channels o0..o0+TO;
// the batch is walked in passes of BT rows.
template <int CAST, int G>
__global__ void __launch_bounds__(TM * TY)
dense_bwd_w_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const typename Load<G>::T* __restrict__ gr,
                   const typename Load<G>::T* __restrict__ gi,
                   float* __restrict__ dwr, float* __restrict__ dwi,
                   int B, int I, int O, int M) {
  __shared__ float sxr[BT][TY][TM];
  __shared__ float sxi[BT][TY][TM];
  __shared__ float sgr[BT][TO][TM];
  __shared__ float sgi[BT][TO][TM];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m0 = blockIdx.x * TM;
  const int m = m0 + tx;
  const int i0 = blockIdx.y * TY;
  const int i = i0 + ty;
  const int o0 = blockIdx.z * TO;
  const int tid = ty * TM + tx;

  float accr[TO], acci[TO];
#pragma unroll
  for (int k = 0; k < TO; ++k) {
    accr[k] = 0.f;
    acci[k] = 0.f;
  }

  for (int b0 = 0; b0 < B; b0 += BT) {
    // stage x[b0:b0+BT, i0:i0+TY, m-tile] and g[b0:b0+BT, o0:o0+TO, m-tile]
    for (int t = tid; t < BT * TY * TM; t += TM * TY) {
      const int mm = t % TM;
      const int ii = (t / TM) % TY;
      const int bb = t / (TM * TY);
      const int gm = m0 + mm, gb = b0 + bb, gi_ = i0 + ii;
      float vr = 0.f, vi = 0.f;
      if (gm < M && gb < B && gi_ < I) {
        const size_t off = (static_cast<size_t>(gb) * I + gi_) * M + gm;
        vr = round_to<CAST>(xr[off]);
        vi = round_to<CAST>(xi[off]);
      }
      sxr[bb][ii][mm] = vr;
      sxi[bb][ii][mm] = vi;
    }
    for (int t = tid; t < BT * TO * TM; t += TM * TY) {
      const int mm = t % TM;
      const int oo = (t / TM) % TO;
      const int bb = t / (TM * TO);
      const int gm = m0 + mm, gb = b0 + bb, go = o0 + oo;
      float vr = 0.f, vi = 0.f;
      if (gm < M && gb < B && go < O) {
        const size_t off = (static_cast<size_t>(gb) * O + go) * M + gm;
        vr = round_to<CAST>(Load<G>::cvt(gr[off]));
        vi = round_to<CAST>(Load<G>::cvt(gi[off]));
      }
      sgr[bb][oo][mm] = vr;
      sgi[bb][oo][mm] = vi;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float p = sxr[b][ty][tx], q = sxi[b][ty][tx];
#pragma unroll
      for (int k = 0; k < TO; ++k) {
        const float u = sgr[b][k][tx], v = sgi[b][k][tx];
        accr[k] = fmaf(p, u, accr[k]);
        accr[k] = fmaf(q, v, accr[k]);
        acci[k] = fmaf(p, v, acci[k]);
        acci[k] = fmaf(-q, u, acci[k]);
      }
    }
    __syncthreads();
  }

  if (m >= M || i >= I) return;
#pragma unroll
  for (int k = 0; k < TO; ++k) {
    if (o0 + k < O) {
      const size_t off = (static_cast<size_t>(i) * O + o0 + k) * M + m;
      dwr[off] = accr[k];
      dwi[off] = acci[k];
    }
  }
}

template <int CAST, int G>
void launch_x(const void* gr, const void* gi, const float* wr, const float* wi,
              float* dxr, float* dxi, int B, int I, int O, int M,
              cudaStream_t stream) {
  using T = typename Load<G>::T;
  const dim3 block(TM, TY, 1);
  const dim3 grid((M + TM - 1) / TM, (I + TY - 1) / TY, (B + BT - 1) / BT);
  dense_bwd_x_kernel<CAST, G><<<grid, block, 0, stream>>>(
      static_cast<const T*>(gr), static_cast<const T*>(gi), wr, wi, dxr, dxi,
      B, I, O, M);
}

template <int CAST, int G>
void launch_w(const float* xr, const float* xi, const void* gr, const void* gi,
              float* dwr, float* dwi, int B, int I, int O, int M,
              cudaStream_t stream) {
  using T = typename Load<G>::T;
  const dim3 block(TM, TY, 1);
  const dim3 grid((M + TM - 1) / TM, (I + TY - 1) / TY, (O + TO - 1) / TO);
  dense_bwd_w_kernel<CAST, G><<<grid, block, 0, stream>>>(
      xr, xi, static_cast<const T*>(gr), static_cast<const T*>(gi), dwr, dwi,
      B, I, O, M);
}

// (CAST, G) -> one instantiation of F; -1 for an unknown format code.
template <template <int, int> class F, typename... Args>
int dispatch(int cast_fmt, int g_fmt, Args... args) {
#define REPRO_CASE(C, G)                          \
  if (cast_fmt == C && g_fmt == G) {              \
    F<C, G>::run(args...);                        \
    return 0;                                     \
  }
  REPRO_CASE(FMT_F32, FMT_F32)
  REPRO_CASE(FMT_F32, FMT_BF16)
  REPRO_CASE(FMT_F32, FMT_F16)
  REPRO_CASE(FMT_BF16, FMT_F32)
  REPRO_CASE(FMT_BF16, FMT_BF16)
  REPRO_CASE(FMT_BF16, FMT_F16)
  REPRO_CASE(FMT_F16, FMT_F32)
  REPRO_CASE(FMT_F16, FMT_BF16)
  REPRO_CASE(FMT_F16, FMT_F16)
#undef REPRO_CASE
  return -1;
}

template <int C, int G>
struct RunX {
  static void run(const void* gr, const void* gi, const float* wr,
                  const float* wi, float* dxr, float* dxi, int B, int I, int O,
                  int M, cudaStream_t s) {
    launch_x<C, G>(gr, gi, wr, wi, dxr, dxi, B, I, O, M, s);
  }
};

template <int C, int G>
struct RunW {
  static void run(const float* xr, const float* xi, const void* gr,
                  const void* gi, float* dwr, float* dwi, int B, int I, int O,
                  int M, cudaStream_t s) {
    launch_w<C, G>(xr, xi, gr, gi, dwr, dwi, B, I, O, M, s);
  }
};

}  // namespace

// C interface, loaded with ctypes.  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (or -1 for an unknown format
// code; the Python wrapper validates first).  g is (B, O, M) at g_fmt;
// w and dw are (I, O, M), x and dx (B, I, M), all f32 but g, contiguous.
extern "C" int spectral_contract_dense_bwd_x(
    const void* gr, const void* gi, const void* wr, const void* wi, void* dxr,
    void* dxi, int B, int I, int O, int M, int cast_fmt, int g_fmt,
    void* stream) {
  const int rc = dispatch<RunX>(
      cast_fmt, g_fmt, gr, gi, static_cast<const float*>(wr),
      static_cast<const float*>(wi), static_cast<float*>(dxr),
      static_cast<float*>(dxi), B, I, O, M, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spectral_contract_dense_bwd_w(
    const void* xr, const void* xi, const void* gr, const void* gi, void* dwr,
    void* dwi, int B, int I, int O, int M, int cast_fmt, int g_fmt,
    void* stream) {
  const int rc = dispatch<RunW>(
      cast_fmt, g_fmt, static_cast<const float*>(xr),
      static_cast<const float*>(xi), gr, gi, static_cast<float*>(dwr),
      static_cast<float*>(dwi), B, I, O, M, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
