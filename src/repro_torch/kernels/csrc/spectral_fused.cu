// The fused spectral layer of a dense FNO, rFFT -> contract -> irFFT, forward
// (fused_fwd) and backward (fused_bwd), for Hopper (sm_90a).
//
// Replace the TPU kernels `_fused_fwd_kernel` and `_fused_bwd_kernel` in
// src/repro/kernels/spectral_contract.py, reached through
// `spectral_fused_pallas` and its custom VJP `_fused_op_bwd`.  Per batch tile
// of bb rows, with x (bb, I, *S) real f32, the corner-gathered weight w
// (I, O, Mh) split-real f32, and Mh = prod R the retained rows (R_k = 2 m_k on
// every axis but the last, m on the last):
//
//   fused_fwd:  xh = q(F x)                          truncated forward DFT, then
//                                                    the fft_in quantisation q
//               yh[b,o,k] = sum_i xh[b,i,k] c(w[i,o,k])   c: storage rounding
//               y = G yh                             inverse DFT, hermitian fold
//   fused_bwd:  xh = q(F x)  (recomputed)
//               gh = c(G^H g)                        adjoint of the inverse
//               dxh[b,i,k] = sum_o gh * conj(c(w)),  dw[i,o,k] = sum_b conj(xh) * gh
//               dx = Re F^H dxh
//
// q is the simulated fp8 grid (clip to +-FORMAT_MAX, the frexp mantissa
// rounded half to even to 3 or 2 bits, f32 subnormals flushed to signed
// zero), then the bf16/fp16 round trip; c is the round trip alone.  Every
// sum is f32; a product of two bf16 or two fp16 values is exact in f32, so
// the f32 FMAs compute what the TPU's half matmuls with f32 accumulation
// compute, up to the order of the sums.  y, dx and dw are f32 with no store
// rounding, as the reference returns them.  The factors are the reference's
// f64 `fused_factors` cast to f32, laid out by the wrapper (see the pack
// below): per axis k, the forward DFT rows F_k, the inverse G_k (for the last
// axis the real-output pair C_re, C_im with hermitian weights 1 at DC and at
// an even-S Nyquist row, 2 elsewhere), and their adjoints.
//
// What bounds them.  At the Darcy path's shape (bb = 8, I = O = 64, 128x128,
// modes 32x32, Mh = 2048) fused_fwd moves 134 MB (x, y and the f32 weight):
// 40 us at 3.35 TB/s; fused_bwd moves 235 MB: 70 us.  Both are bound by
// bytes: counted with an FFT for the transforms (0.43 MFLOP per slab) and
// the contraction (0.54 GFLOP per forward), the operations take 15 and 26 us
// at the 67 TFLOP/s f32 rate.
// These kernels compute the truncated DFT as f32 FMAs instead (the last axis
// first: 4.2 MFLOP per slab, 4.8 GFLOP per forward, 7.5 per backward), so
// their own work takes at least 72 and 112 us on the CUDA cores.
//
// What the design does about it, simply: one cooperative launch per batch
// tile and direction, three stages separated by grid.sync().  The truncated
// spectra (xh and yh; in the backward xh, gh and dxh: 16 and 24 MiB at the
// Darcy shape) live in a global scratch that the wrapper allocates at the
// backward's size (the forward fills its first bb (I + O) Mh values), sized
// to fit the 50 MB L2; the full-size spectrum of the staged path is never
// written.  Transform stages take one (b, channel) slab per block, the last
// axis first (it shrinks the slab most), each axis a loop of f32 FMAs whose
// intermediate sits in shared memory (S0 x R1 complex for a 2-d slab:
// 108 KB at 421x421) and whose factors stream from L1/L2 (a 421-point
// factor is 215 KB, too large to stage).  The contraction stages hold one
// mode's bb batch rows in registers: a thread owns (o, k) in the forward
// and (i, k) in the backward, where it sums dxh over o and, in the same
// loop, dw[i, o, k] over the tile's rows.  dw of later batch tiles is added
// to the earlier tiles' sum in tile order: no atomics, so a rerun is
// bit-identical.  Tensor cores for the DFT stages, a cluster per batch row
// with the spectrum in distributed shared memory, and TMA are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per block
constexpr int MAXBB = 8;          // batch rows of one launch (kept in registers)
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may opt in to

enum { CAST_NONE = 0, CAST_BF16 = 1, CAST_F16 = 2 };
enum { SIM_NONE = 0, SIM_E4M3 = 1, SIM_E5M2 = 2 };

// The factor pack: per axis k, eight R_k x S_k matrices of f32, in this
// order.  Analysis matrices (real slab -> spectrum) are laid out [S][R],
// synthesis matrices (spectrum -> real slab) [R][S].
//   AX: F_k, the forward DFT rows                    (x -> xh)
//   SY: G_k; on the last axis C_re, C_im             (yh -> y)
//   AG: conj(G_k); on the last axis C_re, C_im       (g -> gh, adjoint of SY)
//   SD: conj(F_k); on the last axis F_re, F_im       (dxh -> dx, adjoint of AX)
enum { AX_RE, AX_IM, SY_RE, SY_IM, AG_RE, AG_IM, SD_RE, SD_IM };

struct Dims {
  int nd;               // spatial axes, 1 to 3
  int S[3], R[3];       // grid points and retained rows per axis
  long long N, Mh;      // points and retained modes of one slab
  long long fac[3];     // offset of each axis' matrices in the pack
  long long buf1, buf2; // complex elements of the two shared-memory buffers
  int I, O, bb;
};

Dims make_dims(int bb, int I, int O, int nd, int S0, int S1, int S2, int m0, int m1,
               int m2) {
  Dims D{};
  D.nd = nd;
  const int S[3] = {S0, S1, S2}, m[3] = {m0, m1, m2};
  D.N = 1;
  D.Mh = 1;
  long long off = 0;
  for (int k = 0; k < 3; ++k) {
    D.S[k] = k < nd ? S[k] : 1;
    D.R[k] = k < nd ? (k == nd - 1 ? m[k] : 2 * m[k]) : 1;
    D.fac[k] = off;
    if (k < nd) {
      D.N *= D.S[k];
      D.Mh *= D.R[k];
      off += 8LL * D.R[k] * D.S[k];
    }
  }
  // 2-d: the slab after the last axis, S0 x R1; 3-d: S0 x S1 x R2, and
  // S0 x R1 x R2 after the middle axis
  if (nd == 2) D.buf1 = 1LL * D.S[0] * D.R[1];
  if (nd == 3) {
    D.buf1 = 1LL * D.S[0] * D.S[1] * D.R[2];
    D.buf2 = 1LL * D.S[0] * D.R[1] * D.R[2];
  }
  D.I = I;
  D.O = O;
  D.bb = bb;
  return D;
}

long long smem_bytes(const Dims& D) { return 8LL * (D.buf1 + D.buf2); }

// -- rounding -------------------------------------------------------------------
__device__ __forceinline__ float to_fp8_grid(float v, int sim) {
  if (v != v) return v;
  const int bits = sim == SIM_E4M3 ? 3 : 2;
  const float fmax = sim == SIM_E4M3 ? 448.f : 57344.f;
  v = fminf(fmaxf(v, -fmax), fmax);
  if (fabsf(v) < 1.17549435e-38f) return v * 0.f;
  int e;
  const float m = frexpf(v, &e);
  const float scale = float(1 << (bits + 1));
  return ldexpf(rintf(m * scale) / scale, e);
}

__device__ __forceinline__ float quant(float v, int cast, int sim) {
  if (sim != SIM_NONE) v = to_fp8_grid(v, sim);
  if (cast == CAST_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (cast == CAST_F16) return __half2float(__float2half_rn(v));
  return v;
}

// -- one axis of a slab, by the whole block ---------------------------------------
// out[p][j] = sum_l x[p][l] (fr + i fi)[l][j]: a real slab's last axis
__device__ void real_to_cplx(const float* __restrict__ x, long long P, int L, int J,
                             const float* __restrict__ fr, const float* __restrict__ fi,
                             float* outr, float* outi, int cast, int sim) {
  const long long total = P * J;
  for (long long t = threadIdx.x; t < total; t += NT) {
    const long long p = t / J;
    const int j = int(t - p * J);
    const float* row = x + p * L;
    float sr = 0.f, si = 0.f;
    for (int l = 0; l < L; ++l) {
      const float v = row[l];
      sr = fmaf(v, fr[l * J + j], sr);
      si = fmaf(v, fi[l * J + j], si);
    }
    outr[t] = quant(sr, cast, sim);
    outi[t] = quant(si, cast, sim);
  }
}

// out[a][j][c] = sum_l (fr + i fi)[l][j] in[a][l][c]: a complex axis.  ``in``
// is shared memory or the scratch (never read through the read-only path:
// other blocks wrote it in this launch)
__device__ void cplx_to_cplx(const float* inr, const float* ini, long long A, int L, int J,
                             int C, const float* __restrict__ fr,
                             const float* __restrict__ fi, float* outr, float* outi,
                             int cast, int sim) {
  const long long total = A * J * C;
  for (long long t = threadIdx.x; t < total; t += NT) {
    const int c = int(t % C);
    const long long aj = t / C;
    const int j = int(aj % J);
    const long long a = aj / J;
    const float* pr = inr + a * L * C + c;
    const float* pi = ini + a * L * C + c;
    float sr = 0.f, si = 0.f;
    for (int l = 0; l < L; ++l) {
      const float vr = pr[1LL * l * C], vi = pi[1LL * l * C];
      const float gr = fr[l * J + j], gi = fi[l * J + j];
      sr = fmaf(vr, gr, sr);
      sr = fmaf(-vi, gi, sr);
      si = fmaf(vr, gi, si);
      si = fmaf(vi, gr, si);
    }
    outr[t] = quant(sr, cast, sim);
    outi[t] = quant(si, cast, sim);
  }
}

// y[p][j] = sum_l inr[p][l] ar[l][j] + ini[p][l] ai[l][j]: the last axis back
// to a real slab
__device__ void cplx_to_real(const float* inr, const float* ini, long long P, int L, int J,
                             const float* __restrict__ ar, const float* __restrict__ ai,
                             float* __restrict__ y) {
  const long long total = P * J;
  for (long long t = threadIdx.x; t < total; t += NT) {
    const long long p = t / J;
    const int j = int(t - p * J);
    const float* pr = inr + p * L;
    const float* pi = ini + p * L;
    float s = 0.f;
    for (int l = 0; l < L; ++l) {
      s = fmaf(pr[l], ar[l * J + j], s);
      s = fmaf(pi[l], ai[l * J + j], s);
    }
    y[t] = s;
  }
}

__device__ __forceinline__ const float* mat(const float* fac, const Dims& D, int k, int q) {
  return fac + D.fac[k] + 1LL * q * D.R[k] * D.S[k];
}

// A real slab (N values) -> its truncated spectrum (Mh complex), the last
// axis first; the result, rounded by (cast, sim), goes to global memory.
__device__ void analysis(const float* __restrict__ x, const float* __restrict__ fac,
                         const Dims& D, int re, int im, float* outr, float* outi, float* sm,
                         int cast, int sim) {
  const int* S = D.S;
  const int* R = D.R;
  float* b1r = sm;
  float* b1i = sm + D.buf1;
  float* b2r = sm + 2 * D.buf1;
  float* b2i = b2r + D.buf2;
  if (D.nd == 1) {
    real_to_cplx(x, 1, S[0], R[0], mat(fac, D, 0, re), mat(fac, D, 0, im), outr, outi, cast,
                 sim);
  } else if (D.nd == 2) {
    real_to_cplx(x, S[0], S[1], R[1], mat(fac, D, 1, re), mat(fac, D, 1, im), b1r, b1i,
                 CAST_NONE, SIM_NONE);
    __syncthreads();
    cplx_to_cplx(b1r, b1i, 1, S[0], R[0], R[1], mat(fac, D, 0, re), mat(fac, D, 0, im), outr,
                 outi, cast, sim);
  } else {
    real_to_cplx(x, 1LL * S[0] * S[1], S[2], R[2], mat(fac, D, 2, re), mat(fac, D, 2, im),
                 b1r, b1i, CAST_NONE, SIM_NONE);
    __syncthreads();
    cplx_to_cplx(b1r, b1i, S[0], S[1], R[1], R[2], mat(fac, D, 1, re), mat(fac, D, 1, im), b2r,
                 b2i, CAST_NONE, SIM_NONE);
    __syncthreads();
    cplx_to_cplx(b2r, b2i, 1, S[0], R[0], R[1] * R[2], mat(fac, D, 0, re), mat(fac, D, 0, im),
                 outr, outi, cast, sim);
  }
  __syncthreads();  // the buffers are free for the block's next slab
}

// A truncated spectrum (Mh complex, global) -> a real slab, the leading axes
// first, the last axis folded to real.
__device__ void synthesis(const float* inr, const float* ini, const float* __restrict__ fac,
                          const Dims& D, int re, int im, float* __restrict__ y, float* sm) {
  const int* S = D.S;
  const int* R = D.R;
  float* b1r = sm;
  float* b1i = sm + D.buf1;
  float* b2r = sm + 2 * D.buf1;
  float* b2i = b2r + D.buf2;
  if (D.nd == 1) {
    cplx_to_real(inr, ini, 1, R[0], S[0], mat(fac, D, 0, re), mat(fac, D, 0, im), y);
  } else if (D.nd == 2) {
    cplx_to_cplx(inr, ini, 1, R[0], S[0], R[1], mat(fac, D, 0, re), mat(fac, D, 0, im), b1r,
                 b1i, CAST_NONE, SIM_NONE);
    __syncthreads();
    cplx_to_real(b1r, b1i, S[0], R[1], S[1], mat(fac, D, 1, re), mat(fac, D, 1, im), y);
  } else {
    cplx_to_cplx(inr, ini, 1, R[0], S[0], R[1] * R[2], mat(fac, D, 0, re), mat(fac, D, 0, im),
                 b2r, b2i, CAST_NONE, SIM_NONE);
    __syncthreads();
    cplx_to_cplx(b2r, b2i, S[0], R[1], S[1], R[2], mat(fac, D, 1, re), mat(fac, D, 1, im), b1r,
                 b1i, CAST_NONE, SIM_NONE);
    __syncthreads();
    cplx_to_real(b1r, b1i, 1LL * S[0] * S[1], R[2], S[2], mat(fac, D, 2, re),
                 mat(fac, D, 2, im), y);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// fused_fwd: x -> xh (scratch) | yh = xh . c(w) (scratch) | yh -> y
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wr,
                 const float* __restrict__ wi, const float* __restrict__ fac,
                 float* __restrict__ y, float* scratch, Dims D, int cast, int sim) {
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  const long long IM = 1LL * D.bb * D.I * D.Mh, OM = 1LL * D.bb * D.O * D.Mh;
  float* xhr = scratch;
  float* xhi = xhr + IM;
  float* yhr = xhi + IM;
  float* yhi = yhr + OM;

  for (long long u = blockIdx.x; u < 1LL * D.bb * D.I; u += gridDim.x)
    analysis(x + u * D.N, fac, D, AX_RE, AX_IM, xhr + u * D.Mh, xhi + u * D.Mh, sm, cast, sim);
  grid.sync();

  // a thread owns (o, k) and the tile's rows b of it
  const long long gs = 1LL * gridDim.x * NT;
  for (long long it = 1LL * blockIdx.x * NT + threadIdx.x; it < 1LL * D.O * D.Mh; it += gs) {
    const long long o = it / D.Mh, k = it - o * D.Mh;
    float ar[MAXBB], ai[MAXBB];
#pragma unroll
    for (int b = 0; b < MAXBB; ++b) ar[b] = ai[b] = 0.f;
    for (int i = 0; i < D.I; ++i) {
      const long long wo = (1LL * i * D.O + o) * D.Mh + k;
      const float w_r = quant(wr[wo], cast, SIM_NONE), w_i = quant(wi[wo], cast, SIM_NONE);
#pragma unroll
      for (int b = 0; b < MAXBB; ++b) {
        if (b < D.bb) {
          const long long xo = (1LL * b * D.I + i) * D.Mh + k;
          const float vr = xhr[xo], vi = xhi[xo];
          ar[b] = fmaf(vr, w_r, ar[b]);
          ar[b] = fmaf(-vi, w_i, ar[b]);
          ai[b] = fmaf(vr, w_i, ai[b]);
          ai[b] = fmaf(vi, w_r, ai[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MAXBB; ++b) {
      if (b < D.bb) {
        const long long yo = (1LL * b * D.O + o) * D.Mh + k;
        yhr[yo] = ar[b];
        yhi[yo] = ai[b];
      }
    }
  }
  grid.sync();

  for (long long u = blockIdx.x; u < 1LL * D.bb * D.O; u += gridDim.x)
    synthesis(yhr + u * D.Mh, yhi + u * D.Mh, fac, D, SY_RE, SY_IM, y + u * D.N, sm);
}

// ---------------------------------------------------------------------------
// fused_bwd: x -> xh, g -> gh (scratch) | dxh, dw | dxh -> dx
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
fused_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wr,
                 const float* __restrict__ wi, const float* __restrict__ fac,
                 const float* __restrict__ g, float* __restrict__ dx, float* dwr, float* dwi,
                 float* scratch, Dims D, int cast, int sim, int accumulate) {
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  const long long IM = 1LL * D.bb * D.I * D.Mh, OM = 1LL * D.bb * D.O * D.Mh;
  float* xhr = scratch;
  float* xhi = xhr + IM;
  float* ghr = xhi + IM;
  float* ghi = ghr + OM;
  float* dxr = ghi + OM;
  float* dxi = dxr + IM;

  const long long nx = 1LL * D.bb * D.I, ng = 1LL * D.bb * D.O;
  for (long long u = blockIdx.x; u < nx + ng; u += gridDim.x) {
    if (u < nx) {
      analysis(x + u * D.N, fac, D, AX_RE, AX_IM, xhr + u * D.Mh, xhi + u * D.Mh, sm, cast,
               sim);
    } else {
      const long long v = u - nx;
      analysis(g + v * D.N, fac, D, AG_RE, AG_IM, ghr + v * D.Mh, ghi + v * D.Mh, sm, cast,
               SIM_NONE);
    }
  }
  grid.sync();

  // a thread owns (i, k): dxh[., i, k] summed over o, and dw[i, o, k] summed
  // over the tile's rows in the same loop
  const long long gs = 1LL * gridDim.x * NT;
  for (long long it = 1LL * blockIdx.x * NT + threadIdx.x; it < 1LL * D.I * D.Mh; it += gs) {
    const long long i = it / D.Mh, k = it - i * D.Mh;
    float xr[MAXBB], xi[MAXBB], sr[MAXBB], si[MAXBB];
#pragma unroll
    for (int b = 0; b < MAXBB; ++b) {
      sr[b] = si[b] = 0.f;
      xr[b] = xi[b] = 0.f;
      if (b < D.bb) {
        const long long xo = (1LL * b * D.I + i) * D.Mh + k;
        xr[b] = xhr[xo];
        xi[b] = xhi[xo];
      }
    }
    for (int o = 0; o < D.O; ++o) {
      const long long wo = (i * D.O + o) * D.Mh + k;
      const float w_r = quant(wr[wo], cast, SIM_NONE), w_i = quant(wi[wo], cast, SIM_NONE);
      float tr = 0.f, ti = 0.f;
#pragma unroll
      for (int b = 0; b < MAXBB; ++b) {
        if (b < D.bb) {
          const long long go = (1LL * b * D.O + o) * D.Mh + k;
          const float gr_ = ghr[go], gi_ = ghi[go];
          // dxh = gh . conj(w)
          sr[b] = fmaf(gr_, w_r, sr[b]);
          sr[b] = fmaf(gi_, w_i, sr[b]);
          si[b] = fmaf(gi_, w_r, si[b]);
          si[b] = fmaf(-gr_, w_i, si[b]);
          // dw = conj(xh) . gh
          tr = fmaf(xr[b], gr_, tr);
          tr = fmaf(xi[b], gi_, tr);
          ti = fmaf(xr[b], gi_, ti);
          ti = fmaf(-xi[b], gr_, ti);
        }
      }
      if (accumulate) {
        dwr[wo] += tr;
        dwi[wo] += ti;
      } else {
        dwr[wo] = tr;
        dwi[wo] = ti;
      }
    }
#pragma unroll
    for (int b = 0; b < MAXBB; ++b) {
      if (b < D.bb) {
        const long long xo = (1LL * b * D.I + i) * D.Mh + k;
        dxr[xo] = sr[b];
        dxi[xo] = si[b];
      }
    }
  }
  grid.sync();

  for (long long u = blockIdx.x; u < nx; u += gridDim.x)
    synthesis(dxr + u * D.Mh, dxi + u * D.Mh, fac, D, SD_RE, SD_IM, dx + u * D.N, sm);
}

bool valid(const Dims& D) {
  return D.nd >= 1 && D.nd <= 3 && D.bb >= 1 && D.bb <= MAXBB && D.I >= 1 && D.O >= 1 &&
         smem_bytes(D) <= SMEM_MAX;
}

// One cooperative launch of ``fn``: as many blocks as fit on the card at once.
int launch(const void* fn, const Dims& D, void** args, cudaStream_t stream) {
  if (!valid(D)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(D));
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaLaunchCooperativeKernel(fn, dim3(per_sm * sms), dim3(NT), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of either kernel needs for these axes.
long long spectral_fused_smem(int nd, int S0, int S1, int S2, int m0, int m1, int m2) {
  return smem_bytes(make_dims(1, 1, 1, nd, S0, S1, S2, m0, m1, m2));
}

int spectral_fused_fwd(const float* x, const float* wr, const float* wi, const float* fac,
                       float* y, float* scratch, int bb, int I, int O, int nd, int S0, int S1,
                       int S2, int m0, int m1, int m2, int cast, int sim, void* stream) {
  Dims D = make_dims(bb, I, O, nd, S0, S1, S2, m0, m1, m2);
  void* args[] = {&x, &wr, &wi, &fac, &y, &scratch, &D, &cast, &sim};
  return launch(reinterpret_cast<const void*>(fused_fwd_kernel), D, args,
                static_cast<cudaStream_t>(stream));
}

int spectral_fused_bwd(const float* x, const float* wr, const float* wi, const float* fac,
                       const float* g, float* dx, float* dwr, float* dwi, float* scratch,
                       int bb, int I, int O, int nd, int S0, int S1, int S2, int m0, int m1,
                       int m2, int cast, int sim, int accumulate, void* stream) {
  Dims D = make_dims(bb, I, O, nd, S0, S1, S2, m0, m1, m2);
  void* args[] = {&x, &wr, &wi, &fac, &g, &dx, &dwr, &dwi, &scratch, &D, &cast, &sim,
                  &accumulate};
  return launch(reinterpret_cast<const void*>(fused_bwd_kernel), D, args,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
