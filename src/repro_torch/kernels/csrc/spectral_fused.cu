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
// the contraction's f32 FMAs compute what the TPU's half matmuls with f32
// accumulation compute, up to the order of the sums.  y, dx and dw are f32
// with no store rounding, as the reference returns them.  The factors are
// the reference's f64 `fused_factors` cast to f32.
//
// What bounds them.  At the Darcy path's shape (bb = 8, I = O = 64, 128x128,
// modes 32x32, Mh = 2048) fused_fwd moves 134 MB (x, y and the f32 weight):
// 40 us at 3.35 TB/s; fused_bwd moves 235 MB: 70 us.  Both are bound by
// bytes: counted with an FFT for the transforms (0.43 MFLOP per slab) and
// the contraction (0.54 GFLOP per forward), the operations take 15 and 26 us
// at the 67 TFLOP/s f32 rate.  A truncated DFT applied axis by axis is
// 4.2 MFLOP per slab, 2.1 GFLOP per forward analysis: at least 32 us of f32
// FMAs, but ~13 us on the tensor cores even at six bf16 products a term.
//
// What the design does about it.
// - The transforms are matrix products on the tensor cores.  Applying one
//   axis' factor to a slab is a product of the slab's rows (data, f32) with
//   the factor (K x N): the real last axis of the analysis [x] (L) times
//   [F_re | F_im]; a complex axis [d_re | d_im] (2L) times the 2 x 2 real
//   block [[B_re, B_im], [-B_im, B_re]]; the last axis back to real
//   [d_re | d_im] (2L) times [C_re ; C_im].  Both operands are f32, and the
//   reference transforms in f32, so each is split exactly into three bf16
//   pieces (a = a0 + a1 + a2, `split3`) and the product is the six piece
//   products of order <= 2: what f32 FMAs give, to ~2^-24 relative a term.
//   a0 b0 goes into one f32 accumulator and the five small products into
//   another, added at the store: the tensor cores' f32 sums truncate, and
//   with all six in one accumulator the fp16 mode at 421x421 left a
//   quarter of its quantisation gap.  The factors are split once on the
//   host into the pack (below), the data in registers as its fragments are
//   loaded.  3xTF32 (m16n8k8 on hi/lo pieces, the same peak rate) was
//   slower; tools/kernel_trials.py keeps that variant.
// - A warp owns a (16 WARP_MT) x (8 WARP_NT) tile of `mma.sync.m16n8k16`
//   fragments and walks the step's tiles; the data of the next k step load
//   during the current one's products, and the products run n tile
//   innermost (mma.sync issues in program order; consecutive products then
//   go to independent accumulators).  Every step of a slab runs through one
//   inlined copy of that loop, its descriptor (`Step`) in registers: the
//   step loop not inlined (the descriptor read from local memory), or
//   inlined at every call site (several times the code, past the
//   instruction caches), both ran slower.  A block-level cp.async ring of factor panels
//   and data was no faster at 128x128 and, its ring leaving one block an SM,
//   slower at 421x421; larger warp tiles spill under the register cap.
// - An axis whose length is not a multiple of the mma depth 16 is padded
//   with zero factor rows in the pack, and its data loads past the axis
//   read nothing (they give zero): a slab is never read past its end.
// - The contraction reads each spectrum once: a block takes a tile of CT_T
//   modes, holds the tile's xh (in the backward gh) for all batch rows and a
//   chunk of CT_CH channels in shared memory, and streams the weight once,
//   coalesced along the modes, CT_AHEAD channels of it in flight before
//   their products (one at a time, each waited a DRAM latency).  A thread
//   owns one mode and OPT output (in the backward input) channels, the
//   tile's rows of each in registers; in the backward it sums dxh over o
//   and, in the same loop, dw[i, o, k] over the tile's rows.  The half
//   modes' products are exact, so the CUDA cores' f32 FMAs suffice: 0.54
//   GFLOP is 8 us at the f32 rate, under the 20 us weight read.  dw of later
//   batch tiles is added to the earlier tiles' sum in tile order: no
//   atomics, so a rerun is bit-identical.
// - Work distribution: one cooperative launch per batch tile and direction,
//   three stages separated by grid.sync(), as many blocks as fit (2 an SM:
//   by registers at 128x128, by shared memory at 421x421).  Without its
//   transforms the forward (the contraction, both syncs and the launch)
//   takes ~50 us at 128x128 against the weight read's 20, so separate
//   launches on the scratch would have little to gain.  The truncated
//   spectra (forward: xh and yh; backward: xh, gh and dxh: 16 and 24 MiB at
//   the Darcy shape) stay in a global scratch sized to fit the 50 MB L2;
//   the full-size spectrum of the staged path is never written.  Transform
//   stages take one (b, channel) slab per block, the last axis first (it
//   shrinks the slab most), with the slab's intermediate in shared memory
//   (S0 x R1 complex for a 2-d slab: 108 KB at 421x421, 2 blocks an SM);
//   the intermediate between a slab's axes would not fit the L2 at 421x421
//   (55 MB), so the axes of a slab stay in one block.  Finer units of
//   transform work than a slab, a cluster per slab with its intermediate in
//   distributed shared memory, TMA and `wgmma` are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

using mma_sync::mma16816;
using mma_sync::pack2;

constexpr int NT = 256;           // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MINB = 2;           // blocks an SM the registers are capped for
constexpr int MAXBB = 8;          // batch rows of one launch (kept in registers)
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may opt in to
// (WARP_MT, WARP_NT) fragments of a warp's output tile
constexpr int WARP_MT = 1, WARP_NT = 4;
// the five small piece products in an accumulator of their own (false: all
// six in one)
constexpr bool TWO_ACC = true;
// the contraction's tile: CT_T modes, CT_CH channels of every batch row
constexpr int CT_T = 8;
constexpr int CT_CH = 64;
constexpr int CT_BYTES = MAXBB * CT_CH * CT_T * 8;
constexpr int CT_G = NT / CT_T;    // threads sharing a mode
constexpr int OPT = 2;             // channels a thread owns
constexpr int CT_AHEAD = 4;        // channels whose weights load before their products

enum { CAST_NONE = 0, CAST_BF16 = 1, CAST_F16 = 2 };
enum { SIM_NONE = 0, SIM_E4M3 = 1, SIM_E5M2 = 2 };

// The factor pack: per axis k (0 first), four product matrices B (Kp x Np),
// in this order:
//   AX: F_k, the forward DFT rows                    (x -> xh)
//   SY: G_k; on the last axis C_re, C_im             (yh -> y)
//   AG: conj(G_k); on the last axis C_re, C_im       (g -> gh, adjoint of SY)
//   SD: conj(F_k); on the last axis F_re, F_im       (dxh -> dx, adjoint of AX)
// With (B_re + i B_im)[l][j] the factor that takes index l of the axis to
// index j (out[j] = sum_l B[l][j] d[l]), B is [B_re | B_im] (Lp x 2 Jp) on
// real data (AX, AG on the last axis), [[B_re, B_im], [-B_im, B_re]]
// (2 Lp x 2 Jp) on a complex axis, and [B_re ; B_im] (2 Lp x Jp) to real
// (SY, SD on the last axis).  L, J are the axis' lengths in and out (S_k
// and R_k in the analysis, R_k and S_k in the synthesis), Lp = L rounded up
// to 16 and Jp = J to 8, the padding zero.  Each B is stored as three bf16
// pieces (p0 + p1 + p2 = B exactly), piece after piece, each in fragment
// order: [k step (16 rows)][n tile (8 columns)][lane][2] packed bf16 pairs,
// lane (g, t) = 4 g + t holding rows (2t, 2t+1) and (2t+8, 2t+9) of column
// g: its m16n8k16 B fragment, one 8-byte load.
enum { AX, SY, AG, SD };

struct Fac {
  long long off;  // offset in the pack, uint2 units
  int L, Lp, dparts, J, Jp, oparts;
};

struct Dims {
  int nd;               // spatial axes, 1 to 3
  int S[3], R[3];       // grid points and retained rows per axis
  long long N, Mh;      // points and retained modes of one slab
  Fac fac[3][4];        // [axis][AX, SY, AG, SD]
  long long pack;       // uint2 of the whole pack
  long long buf1, buf2; // complex elements of the two shared-memory buffers
  int I, O, bb;
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

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
    if (k >= nd) continue;
    D.N *= D.S[k];
    D.Mh *= D.R[k];
    for (int q = 0; q < 4; ++q) {
      const bool ana = q == AX || q == AG, last = k == nd - 1;
      Fac& F = D.fac[k][q];
      F.L = ana ? D.S[k] : D.R[k];
      F.J = ana ? D.R[k] : D.S[k];
      F.dparts = ana && last ? 1 : 2;
      F.oparts = !ana && last ? 1 : 2;
      F.Lp = round_up(F.L, 16);
      F.Jp = round_up(F.J, 8);
      F.off = off;
      off += 3LL * F.dparts * F.Lp * F.oparts * F.Jp / 4;
    }
  }
  D.pack = off;
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

// the transform stages' buffers, and at least the contraction's tile
long long smem_bytes(const Dims& D) {
  const long long t = 8LL * (D.buf1 + D.buf2);
  return t > CT_BYTES ? t : CT_BYTES;
}

// -- rounding -------------------------------------------------------------------
// the frexp mantissa rounded half to even to `bits` bits is the f32
// fraction rounded so, on the bits: a carry into the exponent is the next
// power of two, as rint then ldexp give it
__device__ __forceinline__ float to_fp8_grid(float v, int sim) {
  if (v != v) return v;
  const int shift = 23 - (sim == SIM_E4M3 ? 3 : 2);
  const float fmax = sim == SIM_E4M3 ? 448.f : 57344.f;
  v = fminf(fmaxf(v, -fmax), fmax);
  if (fabsf(v) < 1.17549435e-38f) return v * 0.f;
  uint32_t u = __float_as_uint(v);
  u += (1u << (shift - 1)) - 1u + ((u >> shift) & 1u);
  return __uint_as_float(u & ~((1u << shift) - 1u));
}

__device__ __forceinline__ float quant(float v, int cast, int sim) {
  if (sim != SIM_NONE) v = to_fp8_grid(v, sim);
  if (cast == CAST_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (cast == CAST_F16) return __half2float(__float2half_rn(v));
  return v;
}

// (lo, hi) = p0 + p1 + p2 exactly, each p the packed bf16 pair rounded to
// nearest from what the earlier pieces leave
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  p0 = pack2<__nv_bfloat16>(lo, hi);
  lo -= __uint_as_float(p0 << 16);
  hi -= __uint_as_float(p0 & 0xffff0000u);
  p1 = pack2<__nv_bfloat16>(lo, hi);
  lo -= __uint_as_float(p1 << 16);
  hi -= __uint_as_float(p1 & 0xffff0000u);
  p2 = pack2<__nv_bfloat16>(lo, hi);
}

// -- one axis of a slab, by the whole block, as a product on the tensor cores -----
// out[r][n] = sum_k d[r][k] B[k][n] over the rows r of the slab's data.  Row
// r = a C + c sits at d + a dA + c; column k = (part, l) at + part dP + l dL
// (part 1: the imaginary plane).  Column n = (part, j) of the result goes to
// o + a oA + c + part oP + j oJ, rounded by (cast, sim).
struct Step {
  const float* d;
  float* o;
  const uint2* f;  // B's first piece
  long long piece; // uint2 per piece
  int M, C, dA, dL, dP, oA, oJ, oP;
  int L, Lp, dparts, J, Jp, oparts;
  int cast, sim;
};

__device__ __forceinline__ Step step(const Dims& D, int k, int q, const uint2* pack,
                                     const float* d, float* o, int M, int C, int dA, int dL,
                                     int dP, int oA, int oJ, int oP, int cast = CAST_NONE,
                                     int sim = SIM_NONE) {
  const Fac& F = D.fac[k][q];
  Step s;
  s.d = d;
  s.o = o;
  s.f = pack + F.off;
  s.piece = 1LL * F.dparts * F.Lp * F.oparts * F.Jp / 4;
  s.M = M;
  s.C = C;
  s.dA = dA;
  s.dL = dL;
  s.dP = dP;
  s.oA = oA;
  s.oJ = oJ;
  s.oP = oP;
  s.L = F.L;
  s.Lp = F.Lp;
  s.dparts = F.dparts;
  s.J = F.J;
  s.Jp = F.Jp;
  s.oparts = F.oparts;
  s.cast = cast;
  s.sim = sim;
  return s;
}

// the data of k step ks for rows (g, g+8) of each m tile and columns
// (2t, 2t+1, 2t+8, 2t+9): zero past the axis or past the rows
template <int MT>
__device__ __forceinline__ void load_a(const Step& s, const int (&roff)[MT][2], int ks,
                                       int ksp, int t, float (&a)[MT][2][4]) {
  const int part = ks / ksp, l0 = (ks - part * ksp) * 16;
  const float* d = s.d + part * s.dP;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int l = l0 + 2 * t + (e & 1) + 8 * (e >> 1);
    const bool lv = l < s.L;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mt][h][e] = lv && roff[mt][h] >= 0 ? d[roff[mt][h] + l * s.dL] : 0.f;
  }
}

// the A fragments' three bf16 pieces: [mt][piece][a0 (g, 2t..), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..)]
template <int MT>
__device__ __forceinline__ void split_a(const float (&a)[MT][2][4], uint32_t (&ap)[MT][3][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(a[mt][r & 1][2 * (r >> 1)], a[mt][r & 1][2 * (r >> 1) + 1], ap[mt][0][r],
             ap[mt][1][r], ap[mt][2][r]);
}

// the B fragments' three pieces of the first `nvalid` (of NTL) n tiles of
// a k step, from the pack at `fb`
template <int NTL>
__device__ __forceinline__ void load_b(const uint2* fb, long long piece, int nvalid,
                                       uint2 (&b)[NTL][3]) {
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
    for (int q = 0; q < 3; ++q) b[nt][q] = nt < nvalid ? fb[nt * 32 + q * piece] : uint2{};
}

// one k step of the warp's tile: the six piece products of order <= 2 for
// each of the first `nvalid` (of NTL) n tiles.  The products run n tile
// innermost: `mma.sync` is issued in program order, so consecutive products
// then go to independent accumulators instead of waiting on each other.
template <int MT, int NTL>
__device__ __forceinline__ void products(float (&hi)[MT][NTL][4], float (&lo)[MT][NTL][4],
                                         const uint32_t (&ap)[MT][3][4],
                                         const uint2 (&b)[NTL][3], int nvalid) {
  // (A piece, B piece) of each product: a0 b0 into hi, the five small ones
  constexpr int PA[6] = {0, 0, 1, 0, 1, 2}, PB[6] = {0, 1, 0, 2, 1, 0};
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
        if (nt < nvalid)
          mma16816<__nv_bfloat16>(p == 0 || !TWO_ACC ? hi[mt][nt] : lo[mt][nt], ap[mt][PA[p]],
                                  b[nt][PB[p]].x, b[nt][PB[p]].y);
}

// the warp's (16 MT) x (8 NTL) output tile at rows m0.., n tiles f0..: C
// fragment c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
template <int MT, int NTL>
__device__ __forceinline__ void store_tile(const Step& s, const float (&hi)[MT][NTL][4],
                                           const float (&lo)[MT][NTL][4], int m0, int f0,
                                           int nfrag, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * mt + 8 * h + g;
      if (r >= s.M) continue;
      float* o = s.o + (s.C == 1 ? r * s.oA : (r / s.C) * s.oA + r % s.C);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        if (f0 + nt >= nfrag) break;
        const int n = 8 * (f0 + nt) + 2 * t;
        const int part = n >= s.Jp, j = n - part * s.Jp;
        const float v0 = quant(hi[mt][nt][2 * h] + lo[mt][nt][2 * h], s.cast, s.sim);
        const float v1 = quant(hi[mt][nt][2 * h + 1] + lo[mt][nt][2 * h + 1], s.cast, s.sim);
        float* p = o + part * s.oP + j * s.oJ;
        if (j < s.J) p[0] = v0;
        if (j + 1 < s.J) p[s.oJ] = v1;
      }
    }
}

// Each warp walks its output tiles, loading its own data and factor
// fragments.  Inlined: each call site's descriptor folds into registers and
// its pointers keep their address space (shared or global loads).
template <int MT, int NTL>
__device__ __forceinline__ void run_step(const Step& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nfrag = s.oparts * s.Jp / 8;
  const int wm = (s.M + 16 * MT - 1) / (16 * MT), wn = (nfrag + NTL - 1) / NTL;
  const int ksp = s.Lp / 16, nks = s.dparts * ksp;
  for (int wt = warp; wt < wm * wn; wt += NWARPS) {
    const int m0 = (wt / wn) * 16 * MT, f0 = (wt % wn) * NTL;
    int roff[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 16 * mt + 8 * h + g;
        roff[mt][h] = r < s.M ? (r / s.C) * s.dA + r % s.C : -1;
      }
    float hi[MT][NTL][4], lo[MT][NTL][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[mt][nt][e] = lo[mt][nt][e] = 0.f;
    // the data of the next k step load during this one's products
    float a[MT][2][4];
    const uint2* fb = s.f + 1LL * f0 * 32 + lane;
    load_a<MT>(s, roff, 0, ksp, t, a);
#pragma unroll 1
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t ap[MT][3][4];
      split_a<MT>(a, ap);
      uint2 b[NTL][3];
      load_b<NTL>(fb + 32LL * ks * nfrag, s.piece, nfrag - f0, b);
      if (ks + 1 < nks) load_a<MT>(s, roff, ks + 1, ksp, t, a);
      products<MT, NTL>(hi, lo, ap, b, nfrag - f0);
    }
    store_tile<MT, NTL>(s, hi, lo, m0, f0, nfrag, g, t);
  }
}


// Step i of a slab's transform (the slab's nd axis steps, the buffers in
// shared memory between them).  The analysis (a real slab -> its truncated
// spectrum, rounded by (cast, sim) at its last step) takes the last axis
// first; the synthesis (a spectrum -> a real slab) the leading axes first,
// folding the last one to real.  `src` and `dst` are the slab's input and
// output (a spectrum's imaginary plane `plane` after its real one).
__device__ __forceinline__ Step slab_step(const Dims& D, bool ana, int q, int i,
                                          const uint2* pack, const float* src, float* dst,
                                          int plane, float* sm, int cast, int sim) {
  const int* S = D.S;
  const int* R = D.R;
  float* b1 = sm;
  float* b2 = sm + 2 * D.buf1;
  const int p1 = int(D.buf1), p2 = int(D.buf2), R12 = R[1] * R[2];
  const bool last = i == D.nd - 1;
  if (ana) {
    const int k = D.nd - 1 - i, qc = last ? cast : CAST_NONE, qs = last ? sim : SIM_NONE;
    if (D.nd == 1) return step(D, k, q, pack, src, dst, 1, 1, S[0], 1, 0, R[0], 1, plane, qc, qs);
    if (D.nd == 2) {
      if (i == 0) return step(D, k, q, pack, src, b1, S[0], 1, S[1], 1, 0, R[1], 1, p1);
      return step(D, k, q, pack, b1, dst, R[1], R[1], 0, R[1], p1, 0, R[1], plane, qc, qs);
    }
    if (i == 0) return step(D, k, q, pack, src, b1, S[0] * S[1], 1, S[2], 1, 0, R[2], 1, p1);
    if (i == 1)
      return step(D, k, q, pack, b1, b2, S[0] * R[2], R[2], S[1] * R[2], R[2], p1, R12, R[2],
                  p2);
    return step(D, k, q, pack, b2, dst, R12, R12, 0, R12, p2, 0, R12, plane, qc, qs);
  }
  if (D.nd == 1) return step(D, i, q, pack, src, dst, 1, 1, R[0], 1, plane, S[0], 1, 0);
  if (D.nd == 2) {
    if (i == 0) return step(D, i, q, pack, src, b1, R[1], R[1], 0, R[1], plane, 0, R[1], p1);
    return step(D, i, q, pack, b1, dst, S[0], 1, R[1], 1, p1, S[1], 1, 0);
  }
  if (i == 0) return step(D, i, q, pack, src, b2, R12, R12, 0, R12, plane, 0, R12, p2);
  if (i == 1)
    return step(D, i, q, pack, b2, b1, S[0] * R[2], R[2], R12, R[2], p2, S[1] * R[2], R[2],
                p1);
  return step(D, i, q, pack, b1, dst, S[0] * S[1], 1, R[2], 1, p1, S[2], 1, 0);
}

// One slab's transform.  The steps run through one copy of the product
// loop: inlined once per call site of `transform`, it keeps the kernels'
// code small enough for the instruction caches.
__device__ __forceinline__ void transform(const Dims& D, bool ana, int q, const uint2* pack,
                                          const float* src, float* dst, int plane, float* sm,
                                          int cast, int sim) {
#pragma unroll 1
  for (int i = 0; i < D.nd; ++i) {
    run_step<WARP_MT, WARP_NT>(slab_step(D, ana, q, i, pack, src, dst, plane, sm, cast, sim));
    __syncthreads();  // the step's output is the next step's input
  }
}

// the tile's spectra, [b][channel][mode] complex, for channels c0.. (nch of
// them) of a (bb, nc, Mh) pair of planes; modes past Mh zero
__device__ __forceinline__ void load_tile(float2* st, const float* sr, const float* si,
                                          const Dims& D, int nc, int c0, int nch,
                                          long long k0) {
  __syncthreads();
  for (int e = threadIdx.x; e < D.bb * nch * CT_T; e += NT) {
    const int m = e % CT_T, bc = e / CT_T, c = bc % nch, b = bc / nch;
    const long long src = (1LL * b * nc + c0 + c) * D.Mh + k0 + m;
    st[(b * CT_CH + c) * CT_T + m] =
        k0 + m < D.Mh ? make_float2(sr[src], si[src]) : make_float2(0.f, 0.f);
  }
  __syncthreads();
}

// yh[b,o,k] = sum_i xh[b,i,k] c(w[i,o,k]): a block per tile of CT_T modes, a
// thread per (mode, OPT output channels), the sum over i in order
__device__ void contract_fwd(const float* xhr, const float* xhi, const float* __restrict__ wr,
                             const float* __restrict__ wi, float* yhr, float* yhi,
                             const Dims& D, int cast, float* sm) {
  float2* st = reinterpret_cast<float2*>(sm);
  const int kk = threadIdx.x % CT_T, og = threadIdx.x / CT_T;
  for (long long k0 = 1LL * blockIdx.x * CT_T; k0 < D.Mh; k0 += 1LL * gridDim.x * CT_T) {
    const long long k = k0 + kk;
    const bool kv = k < D.Mh;
    for (int ob = 0; ob < D.O; ob += CT_G * OPT) {
      float ar[OPT][MAXBB], ai[OPT][MAXBB];
#pragma unroll
      for (int j = 0; j < OPT; ++j)
#pragma unroll
        for (int b = 0; b < MAXBB; ++b) ar[j][b] = ai[j][b] = 0.f;
      for (int ic = 0; ic < D.I; ic += CT_CH) {
        const int nch = min(CT_CH, D.I - ic);
        load_tile(st, xhr, xhi, D, D.I, ic, nch, k0);
        for (int i0 = 0; i0 < nch; i0 += CT_AHEAD) {
          // the weights of CT_AHEAD channels in flight at once
          float w_r[CT_AHEAD][OPT], w_i[CT_AHEAD][OPT];
#pragma unroll
          for (int u = 0; u < CT_AHEAD; ++u)
#pragma unroll
            for (int j = 0; j < OPT; ++j) {
              const int o = ob + og + CT_G * j;
              w_r[u][j] = w_i[u][j] = 0.f;
              if (kv && o < D.O && i0 + u < nch) {
                const long long wo = (1LL * (ic + i0 + u) * D.O + o) * D.Mh + k;
                w_r[u][j] = wr[wo];
                w_i[u][j] = wi[wo];
              }
            }
#pragma unroll
          for (int u = 0; u < CT_AHEAD; ++u) {
            if (i0 + u >= nch) break;
#pragma unroll
            for (int j = 0; j < OPT; ++j) {
              w_r[u][j] = quant(w_r[u][j], cast, SIM_NONE);
              w_i[u][j] = quant(w_i[u][j], cast, SIM_NONE);
            }
#pragma unroll
            for (int b = 0; b < MAXBB; ++b) {
              if (b < D.bb) {
                const float2 v = st[(b * CT_CH + i0 + u) * CT_T + kk];
#pragma unroll
                for (int j = 0; j < OPT; ++j) {
                  ar[j][b] = fmaf(v.x, w_r[u][j], ar[j][b]);
                  ar[j][b] = fmaf(-v.y, w_i[u][j], ar[j][b]);
                  ai[j][b] = fmaf(v.x, w_i[u][j], ai[j][b]);
                  ai[j][b] = fmaf(v.y, w_r[u][j], ai[j][b]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int o = ob + og + CT_G * j;
        if (!kv || o >= D.O) continue;
#pragma unroll
        for (int b = 0; b < MAXBB; ++b) {
          if (b < D.bb) {
            const long long yo = (1LL * b * D.O + o) * D.Mh + k;
            yhr[yo] = ar[j][b];
            yhi[yo] = ai[j][b];
          }
        }
      }
    }
  }
}

// dxh[b,i,k] = sum_o gh[b,o,k] conj(c(w[i,o,k])) and, in the same loop over
// o, dw[i,o,k] (+)= sum_b conj(xh[b,i,k]) gh[b,o,k]: a block per tile of
// CT_T modes, a thread per (mode, OPT input channels)
__device__ void contract_bwd(const float* xhr, const float* xhi, const float* ghr,
                             const float* ghi, const float* __restrict__ wr,
                             const float* __restrict__ wi, float* dxr, float* dxi, float* dwr,
                             float* dwi, const Dims& D, int cast, int accumulate, float* sm) {
  float2* st = reinterpret_cast<float2*>(sm);
  const int kk = threadIdx.x % CT_T, ig = threadIdx.x / CT_T;
  for (long long k0 = 1LL * blockIdx.x * CT_T; k0 < D.Mh; k0 += 1LL * gridDim.x * CT_T) {
    const long long k = k0 + kk;
    const bool kv = k < D.Mh;
    for (int ib = 0; ib < D.I; ib += CT_G * OPT) {
      float xr[OPT][MAXBB], xi[OPT][MAXBB], sr[OPT][MAXBB], si[OPT][MAXBB];
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int i = ib + ig + CT_G * j;
#pragma unroll
        for (int b = 0; b < MAXBB; ++b) {
          sr[j][b] = si[j][b] = xr[j][b] = xi[j][b] = 0.f;
          if (kv && i < D.I && b < D.bb) {
            const long long xo = (1LL * b * D.I + i) * D.Mh + k;
            xr[j][b] = xhr[xo];
            xi[j][b] = xhi[xo];
          }
        }
      }
      for (int oc = 0; oc < D.O; oc += CT_CH) {
        const int nch = min(CT_CH, D.O - oc);
        load_tile(st, ghr, ghi, D, D.O, oc, nch, k0);
        for (int o0 = 0; o0 < nch; o0 += CT_AHEAD) {
          // the weights of CT_AHEAD channels in flight at once
          float w_r[CT_AHEAD][OPT], w_i[CT_AHEAD][OPT];
#pragma unroll
          for (int u = 0; u < CT_AHEAD; ++u)
#pragma unroll
            for (int j = 0; j < OPT; ++j) {
              const int i = ib + ig + CT_G * j;
              w_r[u][j] = w_i[u][j] = 0.f;
              if (kv && i < D.I && o0 + u < nch) {
                const long long wo = (1LL * i * D.O + oc + o0 + u) * D.Mh + k;
                w_r[u][j] = wr[wo];
                w_i[u][j] = wi[wo];
              }
            }
#pragma unroll
          for (int u = 0; u < CT_AHEAD; ++u) {
            const int o = o0 + u;
            if (o >= nch) break;
            float2 gv[MAXBB];
#pragma unroll
            for (int b = 0; b < MAXBB; ++b)
              gv[b] = b < D.bb ? st[(b * CT_CH + o) * CT_T + kk] : make_float2(0.f, 0.f);
#pragma unroll
            for (int j = 0; j < OPT; ++j) {
              const int i = ib + ig + CT_G * j;
              if (!kv || i >= D.I) continue;
              const long long wo = (1LL * i * D.O + oc + o) * D.Mh + k;
              const float w_r1 = quant(w_r[u][j], cast, SIM_NONE);
              const float w_i1 = quant(w_i[u][j], cast, SIM_NONE);
              float tr = 0.f, ti = 0.f;
#pragma unroll
              for (int b = 0; b < MAXBB; ++b) {
                if (b < D.bb) {
                  // dxh = gh . conj(w)
                  sr[j][b] = fmaf(gv[b].x, w_r1, sr[j][b]);
                  sr[j][b] = fmaf(gv[b].y, w_i1, sr[j][b]);
                  si[j][b] = fmaf(gv[b].y, w_r1, si[j][b]);
                  si[j][b] = fmaf(-gv[b].x, w_i1, si[j][b]);
                  // dw = conj(xh) . gh
                  tr = fmaf(xr[j][b], gv[b].x, tr);
                  tr = fmaf(xi[j][b], gv[b].y, tr);
                  ti = fmaf(xr[j][b], gv[b].y, ti);
                  ti = fmaf(-xi[j][b], gv[b].x, ti);
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
          }
        }
      }
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int i = ib + ig + CT_G * j;
        if (!kv || i >= D.I) continue;
#pragma unroll
        for (int b = 0; b < MAXBB; ++b) {
          if (b < D.bb) {
            const long long xo = (1LL * b * D.I + i) * D.Mh + k;
            dxr[xo] = sr[j][b];
            dxi[xo] = si[j][b];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fused_fwd: x -> xh (scratch) | yh = xh . c(w) (scratch) | yh -> y
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT, MINB)
fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wr,
                 const float* __restrict__ wi, const uint2* __restrict__ pack,
                 float* __restrict__ y, float* scratch, Dims D, int cast, int sim) {
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  const long long IM = 1LL * D.bb * D.I * D.Mh, OM = 1LL * D.bb * D.O * D.Mh;
  float* xhr = scratch;
  float* xhi = xhr + IM;
  float* yhr = xhi + IM;
  float* yhi = yhr + OM;

  for (long long u = blockIdx.x; u < 1LL * D.bb * D.I; u += gridDim.x)
    transform(D, true, AX, pack, x + u * D.N, xhr + u * D.Mh, int(IM), sm, cast, sim);
  grid.sync();
  contract_fwd(xhr, xhi, wr, wi, yhr, yhi, D, cast, sm);
  grid.sync();
  for (long long u = blockIdx.x; u < 1LL * D.bb * D.O; u += gridDim.x)
    transform(D, false, SY, pack, yhr + u * D.Mh, y + u * D.N, int(OM), sm, CAST_NONE,
              SIM_NONE);
}

// ---------------------------------------------------------------------------
// fused_bwd: x -> xh, g -> gh (scratch) | dxh, dw | dxh -> dx
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT, MINB)
fused_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wr,
                 const float* __restrict__ wi, const uint2* __restrict__ pack,
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
    const bool isx = u < nx;
    const long long v = isx ? u : u - nx;
    transform(D, true, isx ? AX : AG, pack, (isx ? x : g) + v * D.N,
              (isx ? xhr : ghr) + v * D.Mh, int(isx ? IM : OM), sm, cast,
              isx ? sim : SIM_NONE);
  }
  grid.sync();
  contract_bwd(xhr, xhi, ghr, ghi, wr, wi, dxr, dxi, dwr, dwi, D, cast, accumulate, sm);
  grid.sync();
  for (long long u = blockIdx.x; u < nx; u += gridDim.x)
    transform(D, false, SD, pack, dxr + u * D.Mh, dx + u * D.N, int(IM), sm, CAST_NONE,
              SIM_NONE);
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

// uint2 (8-byte) words of the factor pack for these axes.
long long spectral_fused_pack_words(int nd, int S0, int S1, int S2, int m0, int m1, int m2) {
  return make_dims(1, 1, 1, nd, S0, S1, S2, m0, m1, m2).pack;
}

int spectral_fused_fwd(const float* x, const float* wr, const float* wi, const uint2* pack,
                       float* y, float* scratch, int bb, int I, int O, int nd, int S0, int S1,
                       int S2, int m0, int m1, int m2, int cast, int sim, void* stream) {
  Dims D = make_dims(bb, I, O, nd, S0, S1, S2, m0, m1, m2);
  void* args[] = {&x, &wr, &wi, &pack, &y, &scratch, &D, &cast, &sim};
  return launch(reinterpret_cast<const void*>(fused_fwd_kernel), D, args,
                static_cast<cudaStream_t>(stream));
}

int spectral_fused_bwd(const float* x, const float* wr, const float* wi, const uint2* pack,
                       const float* g, float* dx, float* dwr, float* dwi, float* scratch,
                       int bb, int I, int O, int nd, int S0, int S1, int S2, int m0, int m1,
                       int m2, int cast, int sim, int accumulate, void* stream) {
  Dims D = make_dims(bb, I, O, nd, S0, S1, S2, m0, m1, m2);
  void* args[] = {&x, &wr, &wi, &pack, &g, &dx, &dwr, &dwi, &scratch, &D, &cast, &sim,
                  &accumulate};
  return launch(reinterpret_cast<const void*>(fused_bwd_kernel), D, args,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
