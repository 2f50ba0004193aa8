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
// What the designs do about it.  dense_bwd_x sums the other channel axis of
// the forward's weight, so it shares dense_fwd's streaming design
// (csrc/dense_stream.cuh): one persistent block an SM streams the weight
// through a cp.async ring of 8-output-channel slabs, g beside it at its own
// width, every operand rounded once by its copier, each output summed over
// o ascending with the same FMAs a term as the kernel before it.  A half g
// is widened into f32 planes once a slot, and rounded there only onto the
// other half format.  dense_bwd_w is a write-streaming
// kernel: one persistent block an SM walks (16-mode, 32-input, 32-output
// channel) tiles, its x and g batch rows coming in through a cp.async ring
// while the previous tile's dw drains as 16-byte stores straight from
// registers (a thread owns a 4 x 4 x 4 (i, o, m) tile, so 16 shared loads
// feed 256 FMAs).  Their 268 MFLOP take 4 us on the f32 cores against the
// 11.9 us of bytes, so both run on the CUDA cores in every mode: the
// products of two rounded values are exact in f32 as on the tensor cores,
// whose per-mode (i, o) fragments would have to be transposed back to the
// m-contiguous streams.  Neither kernel uses atomics: every output is
// reduced by one thread in a fixed order, so a rerun is bit-identical.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "dense_stream.cuh"

namespace {

using namespace dense_stream;

// dense_bwd_w: a thread sums a 4 x 4 x 4 (input channel, output channel,
// mode) tile, so the block tile is WTI x WTO x WTM with WNT = (WTI / 4) *
// (WTO / 4) * (WTM / 4) threads
constexpr int WNT = 256;      // threads per block
constexpr int WTM = 16;       // modes a tile
constexpr int WTI = 32;       // input channels a tile
constexpr int WTO = 32;       // output channels a tile
constexpr int WSTAGES = 3;    // ring slots
constexpr int WXP = WTM + 4;  // x rows' pitch (floats): 16 bytes of padding
static_assert(WNT == (WTI / 4) * (WTO / 4) * (WTM / 4), "a thread sums a 4 x 4 x 4 tile");

// dx[b,i,m] = sum_o g[b,o,m] * conj(w[i,o,m]): the streaming design with g
// (B, O, M) as the summed data operand and the input channels kept
template <int CAST, int G>
__global__ void __launch_bounds__(NT, 1)
dense_bwd_x_kernel(const typename Fmt<G>::T* __restrict__ gr,
                   const typename Fmt<G>::T* __restrict__ gi,
                   const float* __restrict__ wr, const float* __restrict__ wi,
                   float* __restrict__ dxr, float* __restrict__ dxi,
                   int B, int I, int O, int M, int vec, int vecg) {
  contract_stream<CAST, G, FMT_F32, true>(gr, gi, wr, wi, dxr, dxi, B, I, O, M, vec, vecg);
}

// a 16-byte store of dw (`tools/kernel_trials.py` tries st.global.cs)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// dw[i,o,m] = sum_b conj(x[b,i,m]) * g[b,o,m].  Persistent blocks of WNT
// threads, each walking (mode tile of WTM, input tile of WTI, output tile of
// WTO) tiles, modes fastest, so x is read from L2 O / WTO times and g
// I / WTI times: wide channel tiles and a narrow mode tile keep those
// re-reads at a third of the dw bytes at the path's shape (with 64-mode,
// 16 x 16 channel tiles they were 0.75 of them).  A tile's batch rows come
// in chunks of BT rows (8 with a half g, 4 with an f32 one) of x and g
// through a ring of WSTAGES slots filled by cp.async (4 modes a copy: 16
// bytes of x, 16 or 8 of g), so later chunks, and the next tile's first,
// are in flight while one is summed and the last tile's stores drain.
// Each thread rounds the x (and g) values it copied onto CAST in place once
// they land, before the slot's barrier.  Thread (mq, iq, oq) owns modes
// 4 mq.., input channels 4 iq.. and output channels 4 oq..: per batch row,
// 8 float4 reads of x and 8 reads of g feed 256 FMAs, and its dw goes out
// as 16-byte stores along m, straight from registers.
template <int G>
struct WRing {
  using T = typename Fmt<G>::T;
  static constexpr int BT = sizeof(T) == 2 ? 8 : 4;   // batch rows a ring slot
  static constexpr int GP = WTM + 16 / static_cast<int>(sizeof(T));   // g rows' pitch
  static constexpr int X_PLANE = BT * WTI * WXP;       // floats
  static constexpr int G_PLANE = BT * WTO * GP;        // elements of T
  static constexpr int X_BYTES = 2 * X_PLANE * 4;
  static constexpr int STAGE = X_BYTES + 2 * G_PLANE * static_cast<int>(sizeof(T));
  static constexpr int SMEM = WSTAGES * STAGE;   // 120 KB (f32 g), 192 KB (half g)
};

template <int CAST, int G>
__global__ void __launch_bounds__(WNT, 1)   // one block an SM: 128 accumulators a thread
dense_bwd_w_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const typename Fmt<G>::T* __restrict__ gr,
                   const typename Fmt<G>::T* __restrict__ gi,
                   float* __restrict__ dwr, float* __restrict__ dwi,
                   int B, int I, int O, int M, int vec) {
  using T = typename Fmt<G>::T;
  using R = WRing<G>;
  // g needs rounding where its grid is not already inside CAST's; a half g
  // rounded onto the other half format is kept in CAST's own type (SG), which
  // holds it exactly (an fp16 g near 65504 rounds to a bf16 65536)
  constexpr bool ROUND_X = CAST != FMT_F32;
  constexpr bool ROUND_G = CAST != FMT_F32 && G != CAST;
  constexpr int SG = ROUND_G && sizeof(T) == 2 ? CAST : G;
  using S = typename Fmt<SG>::T;
  static_assert(sizeof(S) == sizeof(T), "a staged g fills its slot's element");
  constexpr int UPR = WTM / 4;   // 4-mode units a row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int mq = tid % (WTM / 4), iq = (tid / (WTM / 4)) % (WTI / 4);
  const int oq = tid / (WTM / 4 * (WTI / 4));
  const int nmt = (M + WTM - 1) / WTM, nit = (I + WTI - 1) / WTI, nto = (O + WTO - 1) / WTO;
  // one empty batch chunk where B = 0, so every tile is still stored (zeros)
  const int tiles = nmt * nit * nto, nb = max((B + R::BT - 1) / R::BT, 1);
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int nitems = mine * nb;

  auto xplane = [&](int slot, int p) {
    return reinterpret_cast<float*>(smem_raw + slot * R::STAGE) + p * R::X_PLANE;
  };
  auto gplane = [&](int slot, int p) {
    return reinterpret_cast<S*>(smem_raw + slot * R::STAGE + R::X_BYTES) + p * R::G_PLANE;
  };
  // the k-th tile of this block: its first mode, input and output channel;
  // modes fastest, so the blocks in flight write neighbouring stretches of
  // the same dw rows
  auto tile_of = [&](int k, int& m0, int& i0, int& o0) {
    const int t = blockIdx.x + k * gridDim.x;
    m0 = (t % nmt) * WTM;
    i0 = ((t / nmt) % nit) * WTI;
    o0 = (t / (nmt * nit)) * WTO;
  };

  // item q: batch rows b0.. of tile q / nb, x and g, into ring slot q % WSTAGES
  // (ROUND: round, in place, the units this thread copied once they landed)
  auto stage = [&](int q, bool round) {
    if (q >= nitems) return;
    int m0, i0, o0;
    tile_of(q / nb, m0, i0, o0);
    const int b0 = (q % nb) * R::BT, slot = q % WSTAGES;
    for (int e = tid; e < 2 * R::BT * WTI * UPR; e += WNT) {
      const int p = e / (R::BT * WTI * UPR), row = (e / UPR) % (R::BT * WTI), c = (e % UPR) * 4;
      const int b = b0 + row / WTI, i = i0 + row % WTI;
      float* dst = xplane(slot, p) + row * WXP + c;
      if (round) {
        if (ROUND_X && vec) {
          float4 v = *reinterpret_cast<float4*>(dst);
          v = make_float4(round_to<CAST>(v.x), round_to<CAST>(v.y), round_to<CAST>(v.z),
                          round_to<CAST>(v.w));
          *reinterpret_cast<float4*>(dst) = v;
        }
        continue;
      }
      const float* src = p ? xi : xr;
      const bool ok = b < B && i < I && m0 + c < M;
      const size_t off = ok ? (static_cast<size_t>(b) * I + i) * M + m0 + c : 0;
      if (vec) {
        cp_async16(smem_addr(dst), src + off, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[k] = ok && m0 + c + k < M ? round_to<CAST>(src[off + k]) : 0.f;
      }
    }
    for (int e = tid; e < 2 * R::BT * WTO * UPR; e += WNT) {
      const int p = e / (R::BT * WTO * UPR), row = (e / UPR) % (R::BT * WTO), c = (e % UPR) * 4;
      const int b = b0 + row / WTO, o = o0 + row % WTO;
      S* dst = gplane(slot, p) + row * R::GP + c;
      if (round) {
        if (ROUND_G && vec) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float v = Fmt<G>::ld(reinterpret_cast<const T*>(dst)[k]);
            dst[k] = S(round_to<CAST>(v));
          }
        }
        continue;
      }
      const T* src = p ? gi : gr;
      const bool ok = b < B && o < O && m0 + c < M;
      const size_t off = ok ? (static_cast<size_t>(b) * O + o) * M + m0 + c : 0;
      if (vec) {
        if constexpr (sizeof(T) == 4) {
          cp_async16(smem_addr(dst), src + off, ok ? 16 : 0);
        } else {
          cp_async8(smem_addr(dst), src + off, ok ? 8 : 0);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[k] = ok && m0 + c + k < M ? S(round_to<CAST>(Fmt<G>::ld(src[off + k]))) : S(0.f);
      }
    }
  };

#pragma unroll
  for (int q = 0; q < WSTAGES - 1; ++q) {
    stage(q, false);
    cp_async_commit();
  }

  float accr[4][4][4], acci[4][4][4];   // [input channel][output channel][mode]
  for (int q = 0; q < nitems; ++q) {
    cp_async_wait<WSTAGES - 2>();   // item q has landed
    if (ROUND_X || ROUND_G) stage(q, true);
    __syncthreads();                // and every thread is done with item q - 1
    stage(q + WSTAGES - 1, false);
    cp_async_commit();
    const int bc = q % nb, slot = q % WSTAGES;
    if (bc == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            accr[k][o][c] = 0.f;
            acci[k][o][c] = 0.f;
          }
    }
    const float* sxr = xplane(slot, 0);
    const float* sxi = xplane(slot, 1);
    const S* sgr = gplane(slot, 0);
    const S* sgi = gplane(slot, 1);
    const int nbv = min(R::BT, B - bc * R::BT);
    for (int bb = 0; bb < nbv; ++bb) {
      float p[4][4], qv[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int off = (bb * WTI + 4 * iq + k) * WXP + 4 * mq;
        const float4 a = *reinterpret_cast<const float4*>(sxr + off);
        const float4 b = *reinterpret_cast<const float4*>(sxi + off);
        p[k][0] = a.x, p[k][1] = a.y, p[k][2] = a.z, p[k][3] = a.w;
        qv[k][0] = b.x, qv[k][1] = b.y, qv[k][2] = b.z, qv[k][3] = b.w;
      }
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int off = (bb * WTO + 4 * oq + o) * R::GP + 4 * mq;
        float u[4], v[4];
        if constexpr (sizeof(T) == 4) {
          const float4 a = *reinterpret_cast<const float4*>(sgr + off);
          const float4 b = *reinterpret_cast<const float4*>(sgi + off);
          u[0] = a.x, u[1] = a.y, u[2] = a.z, u[3] = a.w;
          v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
        } else {
          const uint2 a = *reinterpret_cast<const uint2*>(sgr + off);
          const uint2 b = *reinterpret_cast<const uint2*>(sgi + off);
          const S* ha = reinterpret_cast<const S*>(&a);
          const S* hb = reinterpret_cast<const S*>(&b);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            u[c] = Fmt<SG>::ld(ha[c]);
            v[c] = Fmt<SG>::ld(hb[c]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            accr[k][o][c] = fmaf(p[k][c], u[c], accr[k][o][c]);
            accr[k][o][c] = fmaf(qv[k][c], v[c], accr[k][o][c]);
            acci[k][o][c] = fmaf(p[k][c], v[c], acci[k][o][c]);
            acci[k][o][c] = fmaf(-qv[k][c], u[c], acci[k][o][c]);
          }
      }
    }
    if (bc < nb - 1) continue;

    // the tile is summed: 16-byte stores along m, straight from registers
    int m0, i0, o0;
    tile_of(q / nb, m0, i0, o0);
    const int m = m0 + 4 * mq;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 4 * iq + k;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int oo = o0 + 4 * oq + o;
        if (i >= I || oo >= O) continue;
        const size_t off = (static_cast<size_t>(i) * O + oo) * M + m;
        if (vec) {
          if (m < M) {
            const float* a = accr[k][o];
            const float* b = acci[k][o];
            store4(dwr + off, make_float4(a[0], a[1], a[2], a[3]));
            store4(dwi + off, make_float4(b[0], b[1], b[2], b[3]));
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (m + c < M) {
              dwr[off + c] = accr[k][o][c];
              dwi[off + c] = acci[k][o][c];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int CAST, int G>
int launch_w(const float* xr, const float* xi, const void* gr, const void* gi, float* dwr,
             float* dwi, int B, int I, int O, int M, cudaStream_t stream) {
  using T = typename Fmt<G>::T;
  // opt in to more than 48 KB of dynamic shared memory, and count the SMs,
  // once, at the first launch (never inside a CUDA graph capture, which
  // follows a warm-up)
  static const cudaError_t opted = cudaFuncSetAttribute(
      dense_bwd_w_kernel<CAST, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, WRing<G>::SMEM);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 4-mode copies and stores need rows of a multiple of 4 modes and aligned operands
  bool vec = M % 4 == 0;
  for (const void* p : {static_cast<const void*>(xr), static_cast<const void*>(xi),
                        static_cast<const void*>(dwr), static_cast<const void*>(dwi)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const void* p : {gr, gi}) vec = vec && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  const long long tiles =
      1LL * ((M + WTM - 1) / WTM) * ((I + WTI - 1) / WTI) * ((O + WTO - 1) / WTO);
  const int grid = static_cast<int>(std::min<long long>(tiles, sms));
  dense_bwd_w_kernel<CAST, G><<<grid, WNT, WRing<G>::SMEM, stream>>>(
      xr, xi, static_cast<const T*>(gr), static_cast<const T*>(gi), dwr, dwi, B, I, O, M, vec);
  return 0;
}

// (CAST, G) -> one instantiation of F; -1 for an unknown format code.
template <template <int, int> class F, typename... Args>
int dispatch(int cast_fmt, int g_fmt, Args... args) {
#define REPRO_CASE(C, G)                          \
  if (cast_fmt == C && g_fmt == G) {              \
    return F<C, G>::run(args...);                 \
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
  static int run(const void* gr, const void* gi, const float* wr,
                 const float* wi, float* dxr, float* dxi, int B, int I, int O,
                 int M, cudaStream_t s) {
    return launch_stream<&dense_bwd_x_kernel<C, G>, G, FMT_F32>(gr, gi, wr, wi, dxr, dxi, B, I,
                                                                O, M, s);
  }
};

template <int C, int G>
struct RunW {
  static int run(const float* xr, const float* xi, const void* gr,
                 const void* gi, float* dwr, float* dwi, int B, int I, int O,
                 int M, cudaStream_t s) {
    return launch_w<C, G>(xr, xi, gr, gi, dwr, dwi, B, I, O, M, s);
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
