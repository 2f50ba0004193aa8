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
// the rank factors staged in shared memory as f32, so the inner loops read
// shared memory only.  Each block owns a tile of consecutive modes and
// stages its x (and g) tile as f32; every thread owns outputs of the tile in
// a fixed order.  cp_fwd: one block per (mode tile of 32, batch row); a
// thread holds four ranks (or output channels) of one mode in registers, so
// two loads of x (or u) and two float4 broadcasts of the factors feed 16
// FMAs; t and u of the tile live in shared memory.  cp_bwd: one block of 512
// threads per mode tile of 16, looping over the batch so that dW of its
// modes is summed inside the block; dU_i and dU_o of the tile are summed
// across the batch and written as per-tile f32 partials, which a second
// kernel sums in tile order.  No atomics: every output is reduced by one
// thread in a fixed order, so a rerun is bit-identical.
//
// Channel tiles.  Only the rank-sized tiles stay resident in a block's
// shared memory (cp_fwd: t/u, [R][32], 64 KB at R = 256; cp_bwd: u, dt and
// dW, [R][16 or 17], 100 KB at R = 256).  The x (or g) tile and the factors
// are staged in chunks of IC input and OC output channels, which the host
// picks (`cp_fwd_plan`, `cp_bwd_plan` in kernels/spectral_contract.py) so
// that the block fits in 227 KB; a partial sum over the input channels waits
// in the t (or du) tile between chunks, so every sum keeps the order of one
// chunk and a chunked launch is bit-identical to an unchunked one.  cp_bwd
// keeps dU_i and dU_o of its tile in shared memory where they fit and in its
// own slice of the f32 workspace otherwise, each element added to once per
// batch row by one thread, in batch order either way.  At I = O = R, one
// chunk covers both channel axes up to 104 channels in cp_fwd and 101 in
// cp_bwd (dU_i and dU_o in shared memory up to 75), as at the path's 64.  What remains is a limit on the rank
// alone: cp_fwd takes R <= 784 and cp_bwd R <= 558, where the resident
// rank tiles and a one-channel chunk still fit.

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
// chunks of c covering n channels; one (empty) chunk for none
__host__ __device__ inline int n_chunks(int n, int c) { return n > 0 ? (n + c - 1) / c : 1; }

long long fwd_smem_floats(int I, int O, int R, int IC, int OC) {
  (void)I;
  (void)O;
  const long long ic = IC, oc = OC, r = R, rp = pad4(R);
  // t/u [RP][TMF], the x chunk [IC][TMF], the U_i chunk [IC][RP], the
  // U_o^T chunk [R][OC], re/im each
  return 2LL * (rp * TMF + ic * TMF + ic * rp + r * oc);
}

long long bwd_smem_floats(int I, int O, int R, int IC, int OC, int acc_smem) {
  const long long i = I, o = O, r = R, ic = IC, oc = OC;
  // u and dt [R][TP], dW [R][TMB], the x and g chunks [IC|OC][TMB], the
  // U_i and U_o chunks as f32 [IC|OC][R], and, where they fit, dU_i [I][R]
  // and dU_o [O][R], re/im each
  return 2LL * (2 * r * TP + r * TMB + ic * TMB + oc * TMB + ic * r + oc * r +
                (acc_smem ? i * r + o * r : 0));
}

int n_tiles(int M, int tm) { return (M + tm - 1) / tm; }

// ---------------------------------------------------------------------------
// cp_fwd: block (mode tile m0..m0+TMF, batch row b).  A thread owns one mode
// and four consecutive ranks (stage 1) or output channels (stage 3), so each
// pair of x or u loads feeds 16 FMAs against float4 broadcasts of the
// factors, which are staged in shared memory as f32 and zero-padded to a
// multiple of 4.  Stage 1 walks the input channels in chunks of IC, stage 3
// the output channels in chunks of OC (a multiple of 4); without CHUNKED one
// chunk covers each axis and the chunk loops compile away.
// ---------------------------------------------------------------------------
template <int FMT, bool CHUNKED>
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
              int I, int O, int R, int M, int IC, int OC) {
  using F = Fmt<FMT>;
  extern __shared__ __align__(16) float smem[];
  const int RP = pad4(R), OP = pad4(O);
  float* sur = smem;              // t, then u: [RP][TMF]
  float* sui = sur + RP * TMF;
  float* sxr = sui + RP * TMF;    // the x chunk, [IC][TMF]
  float* sxi = sxr + IC * TMF;
  float* sar = sxi + IC * TMF;    // the U_i chunk, [IC][RP]
  float* sai = sar + IC * RP;
  float* sbr = sai + IC * RP;     // the U_o^T chunk, [R][OC]
  float* sbi = sbr + R * OC;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TMF;
  const size_t b = blockIdx.y;
  const int nic = CHUNKED ? n_chunks(I, IC) : 1, noc = CHUNKED ? n_chunks(OP, OC) : 1;

  // U_o^T of output channels o0..o0+OC as f32, zero past O
  auto stage_uo = [&](int o0) {
    for (int t = tid; t < R * OC; t += NT) {
      const int r = t / OC, o = o0 + t % OC;
      sbr[t] = o < O ? F::ld(uor[o * R + r]) : 0.f;
      sbi[t] = o < O ? F::ld(uoi[o * R + r]) : 0.f;
    }
  };
  stage_uo(0);

  // rank-project and mode-scale: u[r][m] = (sum_i x[i][m] U_i[i][r]) W[r][m],
  // the partial sum over earlier chunks waiting in the t tile
  for (int c = 0; c < nic; ++c) {
    const int i0 = c * IC, ni = CHUNKED ? min(IC, I - i0) : I;
    if (c > 0) __syncthreads();
    // the x chunk as f32, zero past M; the U_i chunk as f32, zero past R
    for (int t = tid; t < ni * TMF; t += NT) {
      const int i = i0 + t / TMF, m = m0 + t % TMF;
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        const size_t off = (b * I + i) * M + m;
        vr = F::ld(xr[off]);
        vi = F::ld(xi[off]);
      }
      sxr[t] = vr;
      sxi[t] = vi;
    }
    for (int t = tid; t < ni * RP; t += NT) {
      const int i = i0 + t / RP, r = t % RP;
      sar[t] = r < R ? F::ld(uir[i * R + r]) : 0.f;
      sai[t] = r < R ? F::ld(uii[i * R + r]) : 0.f;
    }
    __syncthreads();

    const bool last = !CHUNKED || c == nic - 1;
    for (int t = tid; t < (RP / 4) * TMF; t += NT) {
      const int r0 = 4 * (t / TMF), mm = t % TMF, m = m0 + mm;
      float tr[4] = {0.f, 0.f, 0.f, 0.f}, ti[4] = {0.f, 0.f, 0.f, 0.f};
      if (CHUNKED && c > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tr[k] = sur[(r0 + k) * TMF + mm];
          ti[k] = sui[(r0 + k) * TMF + mm];
        }
      }
      for (int i = 0; i < ni; ++i) {
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
        if (!last) {
          sur[r * TMF + mm] = tr[k];
          sui[r * TMF + mm] = ti[k];
          continue;
        }
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
  }
  __syncthreads();

  // rank-expand: out[b][o][m] = sum_r u[r][m] U_o[o][r], OC channels at a time
  for (int c = 0; c < noc; ++c) {
    const int o0 = c * OC, nop = CHUNKED ? min(OC, OP - o0) : OP;
    if (c > 0) {
      __syncthreads();
      stage_uo(o0);
      __syncthreads();
    }
    for (int t = tid; t < (nop / 4) * TMF; t += NT) {
      const int oo = 4 * (t / TMF), mm = t % TMF, m = m0 + mm;
      if (m >= M) continue;
      float accr[4] = {0.f, 0.f, 0.f, 0.f}, acci[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < R; ++r) {
        const float ar = sur[r * TMF + mm], ai = sui[r * TMF + mm];
        const float4 br = *reinterpret_cast<const float4*>(sbr + r * OC + oo);
        const float4 bi = *reinterpret_cast<const float4*>(sbi + r * OC + oo);
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
        const int o = o0 + oo + k;
        if (o >= O) break;
        const size_t off = (b * O + o) * M + m;
        outr[off] = F::st(accr[k]);
        outi[off] = F::st(acci[k]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// cp_bwd: block (mode tile m0..m0+TMB), every batch row.  Per row: t over the
// input-channel chunks, du over the output-channel chunks (each partial sum
// waiting in its rank tile), then u, dt and dW per (r, m); then dx and dU_i
// over the input chunks and dU_o over the output chunks.  Without CHUNKED one
// chunk covers each channel axis: the factors are staged once, x and g once
// per row, and t and du are summed in registers in one pass per (r, m).
// ---------------------------------------------------------------------------
template <int FMT, bool CHUNKED>
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
              int B, int I, int O, int R, int M, int IC, int OC, int acc_smem) {
  using F = Fmt<FMT>;
  extern __shared__ __align__(16) float smem[];
  float* sur = smem;              // t, then u: [R][TP]
  float* sui = sur + R * TP;
  float* str = sui + R * TP;      // du, then dt: [R][TP]
  float* sti = str + R * TP;
  float* swr = sti + R * TP;      // dW, [R][TMB]
  float* swi = swr + R * TMB;
  float* sxr = swi + R * TMB;     // the x chunk, [IC][TMB]
  float* sxi = sxr + IC * TMB;
  float* sgr = sxi + IC * TMB;    // the g chunk, [OC][TMB]
  float* sgi = sgr + OC * TMB;
  float* suir = sgi + OC * TMB;   // the U_i chunk as f32, [IC][R]
  float* suii = suir + IC * R;
  float* suor = suii + IC * R;    // the U_o chunk as f32, [OC][R]
  float* suoi = suor + OC * R;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TMB;
  const int nic = CHUNKED ? n_chunks(I, IC) : 1, noc = CHUNKED ? n_chunks(O, OC) : 1;
  // dU_i [I][R] and dU_o [O][R], re/im: in shared memory where they fit,
  // else this tile's slice of the workspace, which the partials go to anyway
  const size_t ir = static_cast<size_t>(I) * R, orr = static_cast<size_t>(O) * R;
  float* p = part + blockIdx.x * 2 * (ir + orr);
  float* sar = acc_smem ? suoi + OC * R : p;
  float* sai = sar + ir;
  float* sbr = sai + ir;
  float* sbi = sbr + orr;

  for (int t = tid; t < R * TMB; t += NTB) {
    swr[t] = 0.f;
    swi[t] = 0.f;
  }
  for (size_t t = tid; t < 2 * (ir + orr); t += NTB) sar[t] = 0.f;

  // the x (and U_i) or g (and U_o) chunk of batch row b as f32, zero past M
  auto stage = [&](size_t b, int n0, int n, int N, const typename F::T* ar,
                   const typename F::T* ai, const typename F::T* fr,
                   const typename F::T* fi, float* sr, float* si, float* ur, float* ui,
                   bool factors) {
    for (int t = tid; t < n * TMB; t += NTB) {
      const int k = n0 + t / TMB, m = m0 + t % TMB;
      float vr = 0.f, vi = 0.f;
      if (m < M) {
        const size_t off = (b * N + k) * M + m;
        vr = F::ld(ar[off]);
        vi = F::ld(ai[off]);
      }
      sr[t] = vr;
      si[t] = vi;
    }
    if (factors) {
      for (int t = tid; t < n * R; t += NTB) {
        ur[t] = F::ld(fr[static_cast<size_t>(n0) * R + t]);
        ui[t] = F::ld(fi[static_cast<size_t>(n0) * R + t]);
      }
    }
  };

  // t[r][m] = sum_i x[i][m] U_i[i][r] over input channels i0..i0+ni,
  // continuing the partial sum (tr, ti)
  auto project = [&](int t, int ni, float& tr, float& ti) {
    const int r = t / TMB, mm = t % TMB;
    for (int i = 0; i < ni; ++i) {
      const float ar = sxr[i * TMB + mm], ai = sxi[i * TMB + mm];
      const float br = suir[i * R + r], bi = suii[i * R + r];
      tr = fmaf(ar, br, tr);
      tr = fmaf(-ai, bi, tr);
      ti = fmaf(ar, bi, ti);
      ti = fmaf(ai, br, ti);
    }
  };
  // du[r][m] = sum_o g[o][m] conj(U_o[o][r]) over output channels o0..o0+no
  auto pullback = [&](int t, int no, float& dur, float& dui) {
    const int r = t / TMB, mm = t % TMB;
    for (int o = 0; o < no; ++o) {
      const float ar = sgr[o * TMB + mm], ai = sgi[o * TMB + mm];
      const float br = suor[o * R + r], bi = suoi[o * R + r];
      dur = fmaf(ar, br, dur);
      dur = fmaf(ai, bi, dur);
      dui = fmaf(ai, br, dui);
      dui = fmaf(-ar, bi, dui);
    }
  };
  // per (r, m): u = t W, dt = du conj(W); dW accumulates du conj(t) over rows
  auto finish = [&](int t, float tr, float ti, float dur, float dui) {
    const int r = t / TMB, mm = t % TMB, m = m0 + mm;
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
  };

  for (size_t b = 0; b < static_cast<size_t>(B); ++b) {
    if (!CHUNKED) {
      stage(b, 0, I, I, xr, xi, uir, uii, sxr, sxi, suir, suii, b == 0);
      stage(b, 0, O, O, gr, gi, uor, uoi, sgr, sgi, suor, suoi, b == 0);
      __syncthreads();
      for (int t = tid; t < R * TMB; t += NTB) {
        float tr = 0.f, ti = 0.f, dur = 0.f, dui = 0.f;
        project(t, I, tr, ti);
        pullback(t, O, dur, dui);
        finish(t, tr, ti, dur, dui);
      }
      __syncthreads();
    } else {
      for (int c = 0; c < nic; ++c) {
        const int i0 = c * IC, ni = min(IC, I - i0);
        stage(b, i0, ni, I, xr, xi, uir, uii, sxr, sxi, suir, suii, true);
        __syncthreads();
        for (int t = tid; t < R * TMB; t += NTB) {
          const int r = t / TMB, mm = t % TMB;
          float tr = c > 0 ? sur[r * TP + mm] : 0.f, ti = c > 0 ? sui[r * TP + mm] : 0.f;
          project(t, ni, tr, ti);
          sur[r * TP + mm] = tr;
          sui[r * TP + mm] = ti;
        }
        __syncthreads();
      }
      for (int c = 0; c < noc; ++c) {
        const int o0 = c * OC, no = min(OC, O - o0);
        stage(b, o0, no, O, gr, gi, uor, uoi, sgr, sgi, suor, suoi, true);
        __syncthreads();
        for (int t = tid; t < R * TMB; t += NTB) {
          const int r = t / TMB, mm = t % TMB;
          float dur = c > 0 ? str[r * TP + mm] : 0.f, dui = c > 0 ? sti[r * TP + mm] : 0.f;
          pullback(t, no, dur, dui);
          str[r * TP + mm] = dur;
          sti[r * TP + mm] = dui;
        }
        __syncthreads();
      }
      for (int t = tid; t < R * TMB; t += NTB) {
        const int r = t / TMB, mm = t % TMB;
        finish(t, sur[r * TP + mm], sui[r * TP + mm], str[r * TP + mm], sti[r * TP + mm]);
      }
      __syncthreads();
    }

    for (int c = 0; c < nic; ++c) {
      const int i0 = c * IC, ni = CHUNKED ? min(IC, I - i0) : I;
      if (CHUNKED && nic > 1) {
        stage(b, i0, ni, I, xr, xi, uir, uii, sxr, sxi, suir, suii, true);
        __syncthreads();
      }
      // dx[b][i][m] = sum_r dt[r][m] conj(U_i[i][r])
      for (int t = tid; t < ni * TMB; t += NTB) {
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
        const size_t off = (b * I + i0 + i) * M + m;
        dxr[off] = F::st(accr);
        dxi[off] = F::st(acci);
      }
      // dU_i[i][r] += sum_m conj(x[i][m]) dt[r][m]
      for (int t = tid; t < ni * R; t += NTB) {
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
        sar[static_cast<size_t>(i0) * R + t] += accr;
        sai[static_cast<size_t>(i0) * R + t] += acci;
      }
      if (CHUNKED) __syncthreads();
    }
    // dU_o[o][r] += sum_m g[o][m] conj(u[r][m])
    for (int c = 0; c < noc; ++c) {
      const int o0 = c * OC, no = CHUNKED ? min(OC, O - o0) : O;
      if (CHUNKED && noc > 1) {
        stage(b, o0, no, O, gr, gi, uor, uoi, sgr, sgi, suor, suoi, false);
        __syncthreads();
      }
      for (int t = tid; t < no * R; t += NTB) {
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
        sbr[static_cast<size_t>(o0) * R + t] += accr;
        sbi[static_cast<size_t>(o0) * R + t] += acci;
      }
      if (CHUNKED) __syncthreads();
    }
    if (!CHUNKED) __syncthreads();
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
  if (acc_smem) {
    for (size_t t = tid; t < 2 * (ir + orr); t += NTB) p[t] = sar[t];
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
               int R, int M, int IC, int OC, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const size_t smem = fwd_smem_floats(I, O, R, IC, OC) * sizeof(float);
  if (smem > SMEM_MAX || IC < 1 || OC < 4 || OC % 4 != 0) return -2;
  // opt in to more than 48 KB of dynamic shared memory once, at the first
  // launch (never inside a CUDA graph capture, which follows a warm-up)
  static const cudaError_t opted[2] = {
      cudaFuncSetAttribute(cp_fwd_kernel<FMT, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX),
      cudaFuncSetAttribute(cp_fwd_kernel<FMT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)};
  if (opted[0] != cudaSuccess) return static_cast<int>(opted[0]);
  if (opted[1] != cudaSuccess) return static_cast<int>(opted[1]);
  const dim3 grid(n_tiles(M, TMF), B, 1);
  const T* const* a = reinterpret_cast<const T* const*>(in);
  auto* kernel = n_chunks(I, IC) > 1 || n_chunks(pad4(O), OC) > 1 ? cp_fwd_kernel<FMT, true>
                                                                    : cp_fwd_kernel<FMT, false>;
  kernel<<<grid, NT, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], static_cast<T*>(outr),
      static_cast<T*>(outi), I, O, R, M, IC, OC);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int launch_bwd(const void* const* in, void* const* out, float* part, int B, int I,
               int O, int R, int M, int IC, int OC, int acc_smem, cudaStream_t stream) {
  using T = typename Fmt<FMT>::T;
  const size_t smem = bwd_smem_floats(I, O, R, IC, OC, acc_smem) * sizeof(float);
  if (smem > SMEM_MAX || IC < 1 || OC < 1) return -2;
  static const cudaError_t opted[2] = {
      cudaFuncSetAttribute(cp_bwd_kernel<FMT, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX),
      cudaFuncSetAttribute(cp_bwd_kernel<FMT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX)};
  if (opted[0] != cudaSuccess) return static_cast<int>(opted[0]);
  if (opted[1] != cudaSuccess) return static_cast<int>(opted[1]);
  const int tiles = n_tiles(M, TMB);
  const T* const* a = reinterpret_cast<const T* const*>(in);
  T* const* d = reinterpret_cast<T* const*>(out);
  auto* kernel = n_chunks(I, IC) > 1 || n_chunks(O, OC) > 1 ? cp_bwd_kernel<FMT, true>
                                                            : cp_bwd_kernel<FMT, false>;
  // out: dx re/im, dU_i re/im, dU_o re/im, dW re/im
  kernel<<<tiles, NTB, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], d[0], d[1], d[6],
      d[7], part, B, I, O, R, M, IC, OC, acc_smem);
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
// format code or -2 for a channel plan whose working set exceeds a block's
// shared memory (the Python wrapper checks both first).  IC and OC are the
// channel chunks of the host's plan; acc_smem says whether cp_bwd keeps dU_i
// and dU_o in shared memory.

extern "C" long long spectral_contract_cp_fwd_smem(int I, int O, int R, int IC, int OC) {
  return fwd_smem_floats(I, O, R, IC, OC) * static_cast<long long>(sizeof(float));
}

extern "C" long long spectral_contract_cp_bwd_smem(int I, int O, int R, int IC, int OC,
                                                   int acc_smem) {
  return bwd_smem_floats(I, O, R, IC, OC, acc_smem) * static_cast<long long>(sizeof(float));
}

// floats of f32 scratch cp_bwd needs: per mode tile, dU_i and dU_o re/im
extern "C" long long spectral_contract_cp_bwd_workspace(int I, int O, int R, int M) {
  return static_cast<long long>(n_tiles(M, TMB)) * 2LL *
         (static_cast<long long>(I) * R + static_cast<long long>(O) * R);
}

extern "C" int spectral_contract_cp_fwd(
    const void* xr, const void* xi, const void* uir, const void* uii,
    const void* uor, const void* uoi, const void* wr, const void* wi, void* outr,
    void* outi, int B, int I, int O, int R, int M, int IC, int OC, int fmt,
    void* stream) {
  const void* in[8] = {xr, xi, uir, uii, uor, uoi, wr, wi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_fwd<FMT_F32>(in, outr, outi, B, I, O, R, M, IC, OC, s);
    case FMT_BF16:
      return launch_fwd<FMT_BF16>(in, outr, outi, B, I, O, R, M, IC, OC, s);
    case FMT_F16:
      return launch_fwd<FMT_F16>(in, outr, outi, B, I, O, R, M, IC, OC, s);
  }
  return -1;
}

extern "C" int spectral_contract_cp_bwd(
    const void* xr, const void* xi, const void* uir, const void* uii,
    const void* uor, const void* uoi, const void* wr, const void* wi,
    const void* gr, const void* gi, void* dxr, void* dxi, void* duir, void* duii,
    void* duor, void* duoi, void* dwr, void* dwi, void* workspace, int B, int I,
    int O, int R, int M, int IC, int OC, int acc_smem, int fmt, void* stream) {
  const void* in[10] = {xr, xi, uir, uii, uor, uoi, wr, wi, gr, gi};
  void* out[8] = {dxr, dxi, duir, duii, duor, duoi, dwr, dwi};
  float* part = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case FMT_F32:
      return launch_bwd<FMT_F32>(in, out, part, B, I, O, R, M, IC, OC, acc_smem, s);
    case FMT_BF16:
      return launch_bwd<FMT_BF16>(in, out, part, B, I, O, R, M, IC, OC, acc_smem, s);
    case FMT_F16:
      return launch_bwd<FMT_F16>(in, out, part, B, I, O, R, M, IC, OC, acc_smem, s);
  }
  return -1;
}
