// CP-factorised spectral contraction (TFNO), forward and backward, for
// Hopper (sm_90a).
//
// Replace the TPU kernels `_cp_fwd_kernel` (cp_fwd) and `_cp_bwd_kernel`
// (cp_bwd) in src/repro/kernels/spectral_contract.py, reached through
// `spectral_contract_cp_pallas` and its custom VJP `_cp_op_bwd`.  The
// dense weight w[i,o,m] = sum_r U_i[i,r] U_o[o,r] W[r,m] is never formed:
// with the mode factor W[r,m] = lam_r prod_k U_mk[m_k,r] folded outside,
// for every retained Fourier mode m
//
//     t[b,m,r]   = sum_i x[b,i,m] * U_i[i,r]        rank-project
//     u[b,m,r]   = t[b,m,r] * W[r,m]                mode-scale
//     out[b,o,m] = sum_r u[b,m,r] * U_o[o,r]        rank-expand   (cp_fwd)
//
// and, given the cotangent g[b,o,m] (cp_bwd, recomputing t and u):
//
//     du   = sum_o g * conj(U_o)        dU_o = sum_{b,m} g * conj(u)
//     dt   = du * conj(W)               dW   = sum_b du * conj(t)
//     dx   = sum_r dt * conj(U_i)       dU_i = sum_{b,m} conj(x) * dt
//
// all complex, in split-real form.  Every operand (x, U_i, U_o, W and g)
// arrives at one dtype T (f32, bf16 or fp16: the caller rounded them to the
// site's storage format).  t, u, du, dt and every sum are f32, never
// rounded: the reference multiplies at preferred_element_type=f32, and a
// product of two bf16 or two fp16 values is exact in f32, so f32 FMAs give
// what its matmuls give up to the order of the sums.  out, dx and dW are
// stored at T; dU_i and dU_o are summed in f32 across mode tiles and then
// stored at T, as `_cp_op_bwd` returns them.
//
// What bounds them.  At the TFNO_NS path's shape (B=8, I=O=R=64,
// M=42*42=1764) cp_fwd does 8*B*M*I*R*2 = 0.925 GFLOP (two complex
// contractions of 4 real FMAs per term); its bytes (x and out 7.2 MB, W
// 0.45 MB at bf16; twice that at f32) take 2.3 us (4.6 us) at 3.35 TB/s.
// cp_bwd does five such contractions, 2.31 GFLOP, against 11.7 MB (bf16)
// of bytes.  In f32 mode every product takes the f32 CUDA cores (67
// TFLOP/s): 13.9 us and 34.8 us.  In a half mode the products of two
// operands at T (t = x*U_i in both kernels, du = g*U_o in cp_bwd) are
// half x half with f32 sums, which the tensor cores compute exactly (989
// TFLOP/s dense); only the products that take the f32 t, u, du or dt
// (u, out, dt, dx, dU_i, dU_o, dW) need the CUDA cores, since the tensor
// cores would round those f32 operands.  That gives about 7.4 us and
// 21.9 us.  Both are bound by operations.
//
// What the design does about it, simply: f32 FMAs on the CUDA cores, with
// the rank factors staged in shared memory as f32 once per block, so the
// inner loops read shared memory only.  Each block owns a tile of
// consecutive modes and stages its x (and g) tile as f32; every thread
// owns outputs of the tile in a fixed order.  cp_fwd: one block per (mode
// tile of 32, batch row); a thread holds four ranks (or output channels)
// of one mode in registers, so two loads of x (or u) and two float4
// broadcasts of the factors feed 16 FMAs; t and u of the tile live in
// shared memory.  cp_bwd: one block of 512 threads per mode tile of 16,
// looping over the batch so that dW of its modes is summed inside the
// block; dU_i and dU_o of the tile are summed in shared memory and written
// as per-tile f32 partials, which a second kernel sums in tile order.  No
// atomics: every output is reduced by one thread in a fixed order, so a
// rerun is bit-identical.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per cp_fwd and reduction block
constexpr int NTB = 512;      // threads per cp_bwd block
constexpr int TMF = 32;       // modes per cp_fwd block
constexpr int TMB = 16;       // modes per cp_bwd block
constexpr int TP = TMB + 1;   // padded row of cp_bwd's [R][TMB] tiles
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may opt in to

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

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

long long fwd_smem_floats(int I, int O, int R) {
  const long long i = I, o = O, r = R;
  // the x tile, U_i as [I][R pad 4], the u tile, U_o transposed [R][O pad 4]
  return 2LL * (i * TMF + i * pad4(R) + r * TMF + r * pad4(O));
}

long long bwd_smem_floats(int I, int O, int R) {
  const long long i = I, o = O, r = R;
  // x and g tiles, u and dt tiles (padded), the dW tile, dU_i and dU_o,
  // and the factors U_i and U_o as f32
  return 2LL * (i * TMB + o * TMB + 2 * r * TP + r * TMB + 2 * (i * r + o * r));
}

int n_tiles(int M, int tm) { return (M + tm - 1) / tm; }

// ---------------------------------------------------------------------------
// cp_fwd: block (mode tile m0..m0+TMF, batch row b).  A thread owns one mode
// and four consecutive ranks (stage 1) or output channels (stage 3), so each
// pair of x or u loads feeds 16 FMAs against float4 broadcasts of the
// factors, which are staged in shared memory as f32 and zero-padded to a
// multiple of 4.
// ---------------------------------------------------------------------------
template <int FMT>
__global__ void __launch_bounds__(NT)
cp_fwd_kernel(const typename Fmt<FMT>::T* __restrict__ xr,
              const typename Fmt<FMT>::T* __restrict__ xi,
              const typename Fmt<FMT>::T* __restrict__ uir,
              const typename Fmt<FMT>::T* __restrict__ uii,
              const typename Fmt<FMT>::T* __restrict__ uor,
              const typename Fmt<FMT>::T* __restrict__ uoi,
              const typename Fmt<FMT>::T* __restrict__ wr,
              const typename Fmt<FMT>::T* __restrict__ wi,
              typename Fmt<FMT>::T* __restrict__ outr,
              typename Fmt<FMT>::T* __restrict__ outi,
              int I, int O, int R, int M) {
  using F = Fmt<FMT>;
  extern __shared__ __align__(16) float smem[];
  const int RP = pad4(R), OP = pad4(O);
  float* sxr = smem;              // [I][TMF]
  float* sxi = sxr + I * TMF;
  float* sar = sxi + I * TMF;     // U_i, [I][RP]
  float* sai = sar + I * RP;
  float* sur = sai + I * RP;      // u, [R][TMF]
  float* sui = sur + R * TMF;
  float* sbr = sui + R * TMF;     // U_o transposed, [R][OP]
  float* sbi = sbr + R * OP;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TMF;
  const size_t b = blockIdx.y;

  // the x tile as f32, zero past M; the factors as f32, zero-padded
  for (int t = tid; t < I * TMF; t += NT) {
    const int i = t / TMF, m = m0 + t % TMF;
    float vr = 0.f, vi = 0.f;
    if (m < M) {
      const size_t off = (b * I + i) * M + m;
      vr = F::ld(xr[off]);
      vi = F::ld(xi[off]);
    }
    sxr[t] = vr;
    sxi[t] = vi;
  }
  for (int t = tid; t < I * RP; t += NT) {
    const int i = t / RP, r = t % RP;
    sar[t] = r < R ? F::ld(uir[i * R + r]) : 0.f;
    sai[t] = r < R ? F::ld(uii[i * R + r]) : 0.f;
  }
  for (int t = tid; t < R * OP; t += NT) {
    const int r = t / OP, o = t % OP;
    sbr[t] = o < O ? F::ld(uor[o * R + r]) : 0.f;
    sbi[t] = o < O ? F::ld(uoi[o * R + r]) : 0.f;
  }
  __syncthreads();

  // rank-project and mode-scale: u[r][m] = (sum_i x[i][m] U_i[i][r]) W[r][m]
  for (int t = tid; t < (RP / 4) * TMF; t += NT) {
    const int r0 = 4 * (t / TMF), mm = t % TMF, m = m0 + mm;
    float tr[4] = {0.f, 0.f, 0.f, 0.f}, ti[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < I; ++i) {
      const float ar = sxr[i * TMF + mm], ai = sxi[i * TMF + mm];
      const float4 br = *reinterpret_cast<const float4*>(sar + i * RP + r0);
      const float4 bi = *reinterpret_cast<const float4*>(sai + i * RP + r0);
      const float pr[4] = {br.x, br.y, br.z, br.w}, pi[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        tr[k] = fmaf(ar, pr[k], tr[k]);
        tr[k] = fmaf(-ai, pi[k], tr[k]);
        ti[k] = fmaf(ar, pi[k], ti[k]);
        ti[k] = fmaf(ai, pr[k], ti[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + k;
      if (r >= R) break;
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        vr = F::ld(wr[static_cast<size_t>(r) * M + m]);
        vi = F::ld(wi[static_cast<size_t>(r) * M + m]);
      }
      sur[r * TMF + mm] = tr[k] * vr - ti[k] * vi;
      sui[r * TMF + mm] = tr[k] * vi + ti[k] * vr;
    }
  }
  __syncthreads();

  // rank-expand: out[b][o][m] = sum_r u[r][m] U_o[o][r]
  for (int t = tid; t < (OP / 4) * TMF; t += NT) {
    const int o0 = 4 * (t / TMF), mm = t % TMF, m = m0 + mm;
    if (m >= M) continue;
    float accr[4] = {0.f, 0.f, 0.f, 0.f}, acci[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < R; ++r) {
      const float ar = sur[r * TMF + mm], ai = sui[r * TMF + mm];
      const float4 br = *reinterpret_cast<const float4*>(sbr + r * OP + o0);
      const float4 bi = *reinterpret_cast<const float4*>(sbi + r * OP + o0);
      const float pr[4] = {br.x, br.y, br.z, br.w}, pi[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        accr[k] = fmaf(ar, pr[k], accr[k]);
        accr[k] = fmaf(-ai, pi[k], accr[k]);
        acci[k] = fmaf(ar, pi[k], acci[k]);
        acci[k] = fmaf(ai, pr[k], acci[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = o0 + k;
      if (o >= O) break;
      const size_t off = (b * O + o) * M + m;
      outr[off] = F::st(accr[k]);
      outi[off] = F::st(acci[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// cp_bwd: block (mode tile m0..m0+TMB), every batch row
// ---------------------------------------------------------------------------
template <int FMT>
__global__ void __launch_bounds__(NTB)
cp_bwd_kernel(const typename Fmt<FMT>::T* __restrict__ xr,
              const typename Fmt<FMT>::T* __restrict__ xi,
              const typename Fmt<FMT>::T* __restrict__ uir,
              const typename Fmt<FMT>::T* __restrict__ uii,
              const typename Fmt<FMT>::T* __restrict__ uor,
              const typename Fmt<FMT>::T* __restrict__ uoi,
              const typename Fmt<FMT>::T* __restrict__ wr,
              const typename Fmt<FMT>::T* __restrict__ wi,
              const typename Fmt<FMT>::T* __restrict__ gr,
              const typename Fmt<FMT>::T* __restrict__ gi,
              typename Fmt<FMT>::T* __restrict__ dxr,
              typename Fmt<FMT>::T* __restrict__ dxi,
              typename Fmt<FMT>::T* __restrict__ dwr,
              typename Fmt<FMT>::T* __restrict__ dwi,
              float* __restrict__ part,
              int B, int I, int O, int R, int M) {
  using F = Fmt<FMT>;
  extern __shared__ __align__(16) float smem[];
  float* sxr = smem;              // [I][TMB]
  float* sxi = sxr + I * TMB;
  float* sgr = sxi + I * TMB;     // [O][TMB]
  float* sgi = sgr + O * TMB;
  float* sur = sgi + O * TMB;     // [R][TP]
  float* sui = sur + R * TP;
  float* str = sui + R * TP;      // dt, [R][TP]
  float* sti = str + R * TP;
  float* swr = sti + R * TP;      // dW, [R][TMB]
  float* swi = swr + R * TMB;
  float* sar = swi + R * TMB;     // dU_i, [I][R]
  float* sai = sar + I * R;
  float* sbr = sai + I * R;       // dU_o, [O][R]
  float* sbi = sbr + O * R;
  float* suir = sbi + O * R;      // U_i as f32, [I][R]
  float* suii = suir + I * R;
  float* suor = suii + I * R;     // U_o as f32, [O][R]
  float* suoi = suor + O * R;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TMB;

  for (int t = tid; t < R * TMB; t += NTB) {
    swr[t] = 0.f;
    swi[t] = 0.f;
  }
  for (int t = tid; t < I * R; t += NTB) {
    sar[t] = 0.f;
    sai[t] = 0.f;
    suir[t] = F::ld(uir[t]);
    suii[t] = F::ld(uii[t]);
  }
  for (int t = tid; t < O * R; t += NTB) {
    sbr[t] = 0.f;
    sbi[t] = 0.f;
    suor[t] = F::ld(uor[t]);
    suoi[t] = F::ld(uoi[t]);
  }

  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    // the x and g tiles of this batch row as f32, zero past M
    for (int t = tid; t < I * TMB; t += NTB) {
      const int i = t / TMB, m = m0 + t % TMB;
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        const size_t off = (b * I + i) * M + m;
        vr = F::ld(xr[off]);
        vi = F::ld(xi[off]);
      }
      sxr[t] = vr;
      sxi[t] = vi;
    }
    for (int t = tid; t < O * TMB; t += NTB) {
      const int o = t / TMB, m = m0 + t % TMB;
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        const size_t off = (b * O + o) * M + m;
        vr = F::ld(gr[off]);
        vi = F::ld(gi[off]);
      }
      sgr[t] = vr;
      sgi[t] = vi;
    }
    __syncthreads();

    // per (r, m): t, u, du, dt; dW accumulates over the batch rows
    for (int t = tid; t < R * TMB; t += NTB) {
      const int r = t / TMB, mm = t % TMB, m = m0 + mm;
      float tr = 0.f, ti = 0.f;
      for (int i = 0; i < I; ++i) {
        const float ar = sxr[i * TMB + mm], ai = sxi[i * TMB + mm];
        const float br = suir[i * R + r], bi = suii[i * R + r];
        tr = fmaf(ar, br, tr);
        tr = fmaf(-ai, bi, tr);
        ti = fmaf(ar, bi, ti);
        ti = fmaf(ai, br, ti);
      }
      float dur = 0.f, dui = 0.f;   // g * conj(U_o)
      for (int o = 0; o < O; ++o) {
        const float ar = sgr[o * TMB + mm], ai = sgi[o * TMB + mm];
        const float br = suor[o * R + r], bi = suoi[o * R + r];
        dur = fmaf(ar, br, dur);
        dur = fmaf(ai, bi, dur);
        dui = fmaf(ai, br, dui);
        dui = fmaf(-ar, bi, dui);
      }
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        vr = F::ld(wr[static_cast<size_t>(r) * M + m]);
        vi = F::ld(wi[static_cast<size_t>(r) * M + m]);
      }
      sur[r * TP + mm] = tr * vr - ti * vi;
      sui[r * TP + mm] = tr * vi + ti * vr;
      str[r * TP + mm] = dur * vr + dui * vi;     // du * conj(W)
      sti[r * TP + mm] = dui * vr - dur * vi;
      swr[t] += dur * tr + dui * ti;              // du * conj(t)
      swi[t] += dui * tr - dur * ti;
    }
    __syncthreads();

    // dx[b][i][m] = sum_r dt[r][m] conj(U_i[i][r])
    for (int t = tid; t < I * TMB; t += NTB) {
      const int i = t / TMB, mm = t % TMB, m = m0 + mm;
      if (m >= M) continue;
      float accr = 0.f, acci = 0.f;
      for (int r = 0; r < R; ++r) {
        const float ar = str[r * TP + mm], ai = sti[r * TP + mm];
        const float br = suir[i * R + r], bi = suii[i * R + r];
        accr = fmaf(ar, br, accr);
        accr = fmaf(ai, bi, accr);
        acci = fmaf(ai, br, acci);
        acci = fmaf(-ar, bi, acci);
      }
      const size_t off = (b * I + i) * M + m;
      dxr[off] = F::st(accr);
      dxi[off] = F::st(acci);
    }
    // dU_i[i][r] += sum_m conj(x[i][m]) dt[r][m]
    for (int t = tid; t < I * R; t += NTB) {
      const int i = t / R, r = t % R;
      float accr = 0.f, acci = 0.f;
      for (int mm = 0; mm < TMB; ++mm) {
        const float ar = sxr[i * TMB + mm], ai = sxi[i * TMB + mm];
        const float br = str[r * TP + mm], bi = sti[r * TP + mm];
        accr = fmaf(ar, br, accr);
        accr = fmaf(ai, bi, accr);
        acci = fmaf(ar, bi, acci);
        acci = fmaf(-ai, br, acci);
      }
      sar[t] += accr;
      sai[t] += acci;
    }
    // dU_o[o][r] += sum_m g[o][m] conj(u[r][m])
    for (int t = tid; t < O * R; t += NTB) {
      const int o = t / R, r = t % R;
      float accr = 0.f, acci = 0.f;
      for (int mm = 0; mm < TMB; ++mm) {
        const float ar = sgr[o * TMB + mm], ai = sgi[o * TMB + mm];
        const float br = sur[r * TP + mm], bi = sui[r * TP + mm];
        accr = fmaf(ar, br, accr);
        accr = fmaf(ai, bi, accr);
        acci = fmaf(ai, br, acci);
        acci = fmaf(-ar, bi, acci);
      }
      sbr[t] += accr;
      sbi[t] += acci;
    }
    __syncthreads();
  }

  // dW of the tile's modes, summed over the batch
  for (int t = tid; t < R * TMB; t += NTB) {
    const int r = t / TMB, m = m0 + t % TMB;
    if (m < M) {
      dwr[static_cast<size_t>(r) * M + m] = F::st(swr[t]);
      dwi[static_cast<size_t>(r) * M + m] = F::st(swi[t]);
    }
  }
  // this tile's f32 partials of dU_i and dU_o: [dUi re | dUi im | dUo re | dUo im]
  const size_t ir = static_cast<size_t>(I) * R, orr = static_cast<size_t>(O) * R;
  float* p = part + blockIdx.x * 2 * (ir + orr);
  for (size_t t = tid; t < ir; t += NTB) {
    p[t] = sar[t];
    p[ir + t] = sai[t];
  }
  for (size_t t = tid; t < orr; t += NTB) {
    p[2 * ir + t] = sbr[t];
    p[2 * ir + orr + t] = sbi[t];
  }
}

// dU_i and dU_o: the per-tile partials summed in tile order, stored at T.
template <int FMT>
__global__ void __launch_bounds__(NT)
cp_bwd_reduce_kernel(const float* __restrict__ part, int tiles, int I, int O, int R,
                     typename Fmt<FMT>::T* __restrict__ duir,
                     typename Fmt<FMT>::T* __restrict__ duii,
                     typename Fmt<FMT>::T* __restrict__ duor,
                     typename Fmt<FMT>::T* __restrict__ duoi) {
  using F = Fmt<FMT>;
  const size_t ir = static_cast<size_t>(I) * R, orr = static_cast<size_t>(O) * R;
  const size_t per = 2 * (ir + orr);
  const size_t e = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  if (e >= per) return;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += part[k * per + e];
  if (e < ir) {
    duir[e] = F::st(s);
  } else if (e < 2 * ir) {
    duii[e - ir] = F::st(s);
  } else if (e < 2 * ir + orr) {
    duor[e - 2 * ir] = F::st(s);
  } else {
    duoi[e - 2 * ir - orr] = F::st(s);
  }
}

template <int FMT>
int launch_fwd(const void* const* in, void* outr, void* outi, int B, int I, int O,
               int R, int M, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const size_t smem = fwd_smem_floats(I, O, R) * sizeof(float);
  if (smem > SMEM_MAX) return -2;
  // opt in to more than 48 KB of dynamic shared memory once, at the first
  // launch (never inside a CUDA graph capture, which follows a warm-up)
  static const cudaError_t opted = cudaFuncSetAttribute(
      cp_fwd_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const dim3 grid(n_tiles(M, TMF), B, 1);
  const T* const* a = reinterpret_cast<const T* const*>(in);
  cp_fwd_kernel<FMT><<<grid, NT, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], static_cast<T*>(outr),
      static_cast<T*>(outi), I, O, R, M);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_bwd(const void* const* in, void* const* out, float* part, int B, int I,
               int O, int R, int M, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const size_t smem = bwd_smem_floats(I, O, R) * sizeof(float);
  if (smem > SMEM_MAX) return -2;
  static const cudaError_t opted = cudaFuncSetAttribute(
      cp_bwd_kernel<FMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int tiles = n_tiles(M, TMB);
  const T* const* a = reinterpret_cast<const T* const*>(in);
  T* const* d = reinterpret_cast<T* const*>(out);
  // out: dx re/im, dU_i re/im, dU_o re/im, dW re/im
  cp_bwd_kernel<FMT><<<tiles, NTB, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], d[0], d[1], d[6],
      d[7], part, B, I, O, R, M);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const size_t per = 2 * (static_cast<size_t>(I) * R + static_cast<size_t>(O) * R);
  const int blocks = static_cast<int>((per + NT - 1) / NT);
  cp_bwd_reduce_kernel<FMT><<<blocks, NT, 0, stream>>>(part, tiles, I, O, R, d[2], d[3],
                                                        d[4], d[5]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  The launchers launch on `stream`,
// allocate nothing, and return cudaGetLastError(), -1 for an unknown
// format code or -2 for a shape whose working set exceeds a block's
// shared memory (the Python wrapper checks both first).

extern "C" long long spectral_contract_cp_fwd_smem(int I, int O, int R, int M) {
  (void)M;
  return fwd_smem_floats(I, O, R) * static_cast<long long>(sizeof(float));
}

extern "C" long long spectral_contract_cp_bwd_smem(int I, int O, int R, int M) {
  (void)M;
  return bwd_smem_floats(I, O, R) * static_cast<long long>(sizeof(float));
}

// floats of f32 scratch cp_bwd needs: per mode tile, dU_i and dU_o re/im
extern "C" long long spectral_contract_cp_bwd_workspace(int I, int O, int R, int M) {
  return static_cast<long long>(n_tiles(M, TMB)) * 2LL *
         (static_cast<long long>(I) * R + static_cast<long long>(O) * R);
}

extern "C" int spectral_contract_cp_fwd(
    const void* xr, const void* xi, const void* uir, const void* uii,
    const void* uor, const void* uoi, const void* wr, const void* wi, void* outr,
    void* outi, int B, int I, int O, int R, int M, int fmt, void* stream) {
  const void* in[8] = {xr, xi, uir, uii, uor, uoi, wr, wi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_fwd<FMT_F32>(in, outr, outi, B, I, O, R, M, s);
    case FMT_BF16:
      return launch_fwd<FMT_BF16>(in, outr, outi, B, I, O, R, M, s);
    case FMT_F16:
      return launch_fwd<FMT_F16>(in, outr, outi, B, I, O, R, M, s);
  }
  return -1;
}

extern "C" int spectral_contract_cp_bwd(
    const void* xr, const void* xi, const void* uir, const void* uii,
    const void* uor, const void* uoi, const void* wr, const void* wi,
    const void* gr, const void* gi, void* dxr, void* dxi, void* duir, void* duii,
    void* duor, void* duoi, void* dwr, void* dwi, void* workspace, int B, int I,
    int O, int R, int M, int fmt, void* stream) {
  const void* in[10] = {xr, xi, uir, uii, uor, uoi, wr, wi, gr, gi};
  void* out[8] = {dxr, dxi, duir, duii, duor, duoi, dwr, dwi};
  float* part = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_bwd<FMT_F32>(in, out, part, B, I, O, R, M, s);
    case FMT_BF16:
      return launch_bwd<FMT_BF16>(in, out, part, B, I, O, R, M, s);
    case FMT_F16:
      return launch_bwd<FMT_F16>(in, out, part, B, I, O, R, M, s);
  }
  return -1;
}
