#!/usr/bin/env python3
"""Try variants of hand-written kernels beside the shipped ones on one GPU.

    python3 tools/kernel_trials.py [--only flash,ls_bwd_w,ls_mix,rmsnorm,cp_fwd,dense_bwd_w,fused,
                                           cp_bwd,dense_fwd,dense_bwd_x]

Each variant is the shipped source, with the ``csrc/`` headers it includes
written out in place, and a few lines of either replaced (``VARIANTS``; one
puts a block of its own in front of a line),
or the shipped library called with another plan than the host's.
Every library is built with the port's nvcc flags into
``build/kernel_trials/`` and called through the same C interface as the
shipped one, on the same operands, in turns (shipped, variants, then in
reverse).  Prints one JSON line per shape and mode:

- ``flash_attention_fwd`` at the LM pool's 32k causal shapes
  (``chip_smoke.FLASH_SHAPES``) in bf16 and fp16: each library's ms and
  its relative L2 to the plain version on 256 query rows, beside the
  yardstick (a quarter of the plain version's gap to the oracle on those
  rows) that ``chip_smoke.py`` holds bf16 to;
- ``spectral_contract_ls_bwd_w`` at the SFNO path's shape in bf16 and f32:
  each library's µs (a CUDA graph of 40 launches cycling operands larger
  than L2) and its largest difference from the plain version;
- ``spectral_contract_ls_fwd`` and ``_ls_bwd_x`` (``ls_mix``) at the SFNO
  path's shape in bf16 and f32, timed the same way: the ring's stages (2
  shipped, 3, 4), the weight's degree slice streamed a chunk a stage
  instead of resident, and two blocks a degree (``splits`` 2) instead of
  one;
- ``rmsnorm_fwd`` at the LM pool's shapes (``chip_smoke.RMS_SHAPES``) in
  bf16 and f32, each a CUDA graph of 20 launches: the shipped plan beside
  other (packs a lane, warps a row, waves of the resident blocks) plans,
  one element a lane, no prefetch of the next row and prefetch at every
  instance; ``F.rms_norm`` timed the same way first and last;
- ``spectral_contract_cp_fwd`` at the TFNO path's shape in bf16, fp16 and
  f32, each a CUDA graph of 40 launches cycling operands larger than L2:
  the half modes' rank-expand on the CUDA cores from u in f32 in shared
  memory instead of the exact bf16 split on the tensor cores, and a ring of
  3 slots instead of 2; each library's largest excess over
  ``store_budget`` (a negative one is inside it) beside its µs, and the
  complex64 ``torch.einsum`` timed the same way; each library also timed
  with a cuFFT transform of the TFNO path's activations before every
  launch (``after_fft_us``: the graph of both less the transform's);
- ``spectral_contract_dense_bwd_w`` at the Darcy path's shape in bf16 and
  f32 mode, timed both ways: rings of 2 and 4 slots instead of 3 (4 do not
  fit with a half g: null), 2- and 4-row slots instead of 8 (4 with an f32
  g), 64-mode, 16 x 16 channel tiles instead of 16-mode, 32 x 32 ones,
  tiles walked channels first instead of modes first, and streaming
  (``st.global.cs``) stores; each library's largest difference from the plain version, and
  the complex64 ``torch.einsum``;
- ``spectral_fused_fwd`` and ``_bwd`` at the Darcy path's shape at 128² and
  421² in bf16, fp16 and f32 mode, CUDA events over back-to-back launches
  cycling two operand sets: the transforms' products as 3xTF32 (``m16n8k8``
  on hi/lo tf32 pieces of both operands, B rebuilt from the pack's bf16
  pieces) instead of the exact three-piece bf16 split, all six piece
  products in one accumulator (with 16 x 32 and 32 x 32 warp tiles), each n
  tile's six products in a row instead of each product over the n tiles,
  warp tiles of 32 x 32 and 16 x 16 instead of 16 x 32, the weights 1 or 8
  channels ahead of their products instead of 4, contraction tiles of 4
  modes instead of 8, registers uncapped (one block an SM), and diagnostics
  without the transforms, the contraction, the products, the factor's
  loads, the data's loads, the transforms' stores or only the y/dx stores;
  each library's
  largest excess over ``chip_smoke.py``'s envelope budget (and in the half
  modes over its quarter-gap limit; negative: inside);
- ``spectral_contract_dense_fwd`` and ``_dense_bwd_x`` (the streaming design
  they share, ``csrc/dense_stream.cuh``) at the Darcy path's shape, CUDA
  graphs of 40 launches cycling operands larger than L2, ``dense_fwd`` in bf16
  and f32 mode, ``dense_bwd_x`` in bf16, fp16 and f32 mode (g at the mode's
  dtype): rings of 2 slots instead of 3, 4-channel slots with 4 or 6 stages,
  (``dense_bwd_x``) tiles walked modes first instead of channels first and
  a widened g stored in the same order by every thread (2-way bank
  conflicts), and diagnostics without rounding, without the sums and
  (``dense_bwd_x``) without widening a half g; each library's largest difference from the plain
  version and whether its output is bit-identical to the shipped one's, and
  for ``dense_bwd_x`` the complex64 ``torch.einsum``.  Variants named ``diag``
  switch a part off (the sums, the stores, a contraction) to show what it
  costs; their answers are wrong by design.

Needs one card.
"""
import argparse
import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.core.precision import FORMAT_EPS, dtype_name  # noqa: E402
from repro_torch.core.theory import contract_budget, store_budget  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import spectral_contract as sc  # noqa: E402

OUT = ROOT / "build" / "kernel_trials"
#: the half modes' rank-expand on the CUDA cores, put in front of the
#: shipped stage 3 (which it leaves unreachable): u in f32 through the
#: slot's x/W area, [r][m], and thread (mq, nq) sums modes 4 mq.. x output
#: channels 8 nq.. (acc_o[re/im][channel][mode])
_CP_STAGE3 = "      // stage 3: out[m][o] += u[m][r] U_o[o][r], u in three exact bf16\n"
_CP_CUDA_CORE_RANK_EXPAND = """      {
        constexpr int UFP = MT + 4;
        float* sur = reinterpret_cast<float*>(st);
        float* sui = sur + RC * UFP;
        __syncthreads();
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int j = 0; j < RC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              (p ? sui : sur)[(8 * j + 2 * t4 + (e & 1)) * UFP + wm + g + 8 * (e >> 1)] =
                  acc_t[p][j][e];
        __syncthreads();
        for (int r = 0; r < nr; ++r) {
          const float4 a4 = *reinterpret_cast<const float4*>(sur + r * UFP + 4 * mq);
          const float4 c4 = *reinterpret_cast<const float4*>(sui + r * UFP + 4 * mq);
          const float ua[4] = {a4.x, a4.y, a4.z, a4.w}, ub[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float pr = F::ld(s_uor[(8 * nq + k) * UP + r]);
            const float pi = F::ld(s_uoi[(8 * nq + k) * UP + r]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc_o[0][k][c] = fmaf(ua[c], pr, acc_o[0][k][c]);
              acc_o[0][k][c] = fmaf(-ub[c], pi, acc_o[0][k][c]);
              acc_o[1][k][c] = fmaf(ua[c], pi, acc_o[1][k][c]);
              acc_o[1][k][c] = fmaf(ub[c], pr, acc_o[1][k][c]);
            }
          }
        }
        if (it.rc < nrc - 1) continue;
        __syncthreads();
        T* sor = st;
        T* soi = st + OC * XP;
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              (p ? soi : sor)[(8 * nq + k) * XP + 4 * mq + c] = F::st(acc_o[p][k][c]);
        __syncthreads();
        const size_t oo = (it.b * O + oc0) * M + it.m0;
        store_rows<T, NT>(outr + oo, M, sor, XP, no, nm, MT, um, tid);
        store_rows<T, NT>(outi + oo, M, soi, XP, no, nm, MT, um, tid);
        continue;
      }
"""
#: variants of the streaming design that dense_fwd and dense_bwd_x share
#: (csrc/dense_stream.cuh), tried on each
_DENSE_STREAM_VARIANTS = {
    "2_stages": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "4_channel_slots": [("constexpr int KCH = 8;", "constexpr int KCH = 4;"),
                        ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "4_channel_slots_6_stages": [("constexpr int KCH = 8;", "constexpr int KCH = 4;"),
                                 ("constexpr int STAGES = 3;", "constexpr int STAGES = 6;")],
    "diag_no_rounding": [
        ("    return __bfloat162float(__float2bfloat16_rn(v));", "    return v;"),
        ("    return __bfloat1622float2(__floats2bfloat162_rn(a, b));", "    return make_float2(a, b);")],
    "diag_no_sums": [("    for (int k = 0; k < KCH; ++k) {", "    for (int k = 0; k < KCH && M < 0; ++k) {")],
}
#: the fused transforms' products as 3xTF32, put in front of the shipped
#: ``run_step``: A split into hi/lo tf32 in registers, B rebuilt in f32 from
#: the pack's three bf16 pieces (exact) and split the same way; per k half,
#: a_hi b_hi into one accumulator, a_hi b_lo + a_lo b_hi into the other.
#: The thread's columns 2t, 2t+1 (2t+8, 2t+9) of a 16-deep k step are the
#: m16n8k8 fragment's k = t, t + 4 of the first (second) half, for A and B
#: alike, so the sum runs over the same k.
_FUSED_RUN_STEP = "// Each warp walks its output tiles, loading its own data and factor\n"
_FUSED_TF32 = """__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// [mt][hi half 0, hi half 1, lo half 0, lo half 1][m16n8k8 A fragment]
template <int MT>
__device__ __forceinline__ void split_a_tf32(const float (&a)[MT][2][4],
                                             uint32_t (&ap)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float v[4] = {a[mt][0][2 * hh], a[mt][1][2 * hh], a[mt][0][2 * hh + 1],
                          a[mt][1][2 * hh + 1]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ap[mt][hh][r] = tf32(v[r]);
        ap[mt][2 + hh][r] = tf32(v[r] - __uint_as_float(ap[mt][hh][r]));
      }
    }
}

template <int MT, int NTL>
__device__ __forceinline__ void products_tf32(float (&hi)[MT][NTL][4], float (&lo)[MT][NTL][4],
                                              const uint32_t (&ap)[MT][4][4],
                                              const uint2 (&b)[NTL][3], int nvalid) {
  uint32_t bh[NTL][4], bl[NTL][4];
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    uint32_t w[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      w[q][0] = b[nt][q].x << 16;
      w[q][1] = b[nt][q].x & 0xffff0000u;
      w[q][2] = b[nt][q].y << 16;
      w[q][3] = b[nt][q].y & 0xffff0000u;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __uint_as_float(w[0][e]) +
                      (__uint_as_float(w[1][e]) + __uint_as_float(w[2][e]));
      bh[nt][e] = tf32(v);
      bl[nt][e] = tf32(v - __uint_as_float(bh[nt][e]));
    }
  }
  // per k half: a_hi b_hi into hi, a_hi b_lo and a_lo b_hi into lo, n tile innermost
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
          if (nt < nvalid)
            mma1688(p == 0 ? hi[mt][nt] : lo[mt][nt], ap[mt][p == 2 ? 2 + hh : hh],
                    (p == 1 ? bl : bh)[nt][2 * hh], (p == 1 ? bl : bh)[nt][2 * hh + 1]);
}

"""
#: name -> (shipped source, [(old line, new line), ...])
VARIANTS = {
    "flash_fast_exp": ("flash_attention.cu", [
        ("const float p0 = expf(s[j][0] - mx[0]), p1 = expf(s[j][1] - mx[0]);",
         "const float p0 = __expf(s[j][0] - mx[0]), p1 = __expf(s[j][1] - mx[0]);"),
        ("const float p2 = expf(s[j][2] - mx[1]), p3 = expf(s[j][3] - mx[1]);",
         "const float p2 = __expf(s[j][2] - mx[1]), p3 = __expf(s[j][3] - mx[1]);")]),
    "flash_8_warps_at_d64": ("flash_attention.cu", [
        ("return D > 64 ? 8 : 4;", "return D > 32 ? 8 : 4;")]),
    "flash_generic_kv_block": ("flash_attention.cu", [
        ("auto* kernel = BK == BKMAX ? flash_fwd_mma_kernel<FMT, D, true>",
         "auto* kernel = false ? flash_fwd_mma_kernel<FMT, D, true>")]),
    "ls_bwd_w_128_byte_rows": ("spectral_contract_lshared.cu", [
        ("static constexpr int STAGES = sizeof(T) == 2 ? 3 : 4;",
         "static constexpr int STAGES = 4;"),
        ("static constexpr int ROW = sizeof(T) == 2 ? 256 : 128;",
         "static constexpr int ROW = 128;")]),
    "ls_mix_3_stages": ("spectral_contract_lshared.cu", [
        ("static constexpr int STAGES = 2; ", "static constexpr int STAGES = 3; ")]),
    "ls_mix_4_stages": ("spectral_contract_lshared.cu", [
        ("static constexpr int STAGES = 2; ", "static constexpr int STAGES = 4; ")]),
    "cp_fwd_cuda_core_rank_expand": ("spectral_contract_cp.cu", [
        (_CP_STAGE3, _CP_CUDA_CORE_RANK_EXPAND + _CP_STAGE3)]),
    "cp_fwd_3_stages": ("spectral_contract_cp.cu", [
        ("static constexpr int STAGES = 2;", "static constexpr int STAGES = 3;")]),
    # diagnostics (their answers are wrong by design): what a part of the
    # kernel costs, by switching it off behind a condition that is false at
    # run time, so the compiler keeps the rest
    "cp_fwd_diag_no_rank_project": ("spectral_contract_cp.cu", [
        ("        for (int ks = 0; ks < nk; ks += 16) {",
         "        for (int ks = 0; ks < nk && M < 0; ks += 16) {")]),
    "cp_fwd_diag_no_rank_expand": ("spectral_contract_cp.cu", [
        ("            if (16 * kk < nr) {", "            if (16 * kk < nr && M < 0) {")]),
    "cp_bwd_all_piece_products": ("spectral_contract_cp.cu", [
        ("      if (p + q > 2) continue;", "      if (p + q > 4) continue;")]),
    "cp_bwd_32_mode_tiles": ("spectral_contract_cp.cu", [
        ("static constexpr int MT = HALF ? 64 : 32;     // modes a tile",
         "static constexpr int MT = 32;     // modes a tile")]),
    "cp_bwd_diag_no_phase_1_products": ("spectral_contract_cp.cu", [
        ("            tr, ti, cdiv(min(CH, I - ic * CH), 16),", "            tr, ti, M < 0,"),
        ("            dr, di, cdiv(min(CH, O - oc * CH), 16),", "            dr, di, M < 0,")]),
    "cp_bwd_diag_no_phase_2_products": ("spectral_contract_cp.cu", [
        ("            xr_, xi_, cdiv(nr, 16),", "            xr_, xi_, M < 0,"),
        ("            duir, duii, mk,", "            duir, duii, M < 0,"),
        ("            duor, duoi, mk,", "            duor, duoi, M < 0,")]),
    "cp_bwd_diag_no_reduction": ("spectral_contract_cp.cu", [
        ("  cp_bwd_reduce_kernel<FMT><<<", "  if (M < 0) cp_bwd_reduce_kernel<FMT><<<")]),
    "cp_bwd_diag_no_dw_terms": ("spectral_contract_cp.cu", [
        ("          if (in) {\n            dwpr[", "          if (in && M < 0) {\n            dwpr[")]),
    "cp_bwd_diag_no_dx_stores": ("spectral_contract_cp.cu", [
        ("            if (i >= ni || m >= nm) continue;",
         "            if (i >= ni || m >= nm || M > 0) continue;")]),
    "cp_bwd_diag_no_loads": ("spectral_contract_cp.cu", [
        ("    if (k < mine) {", "    if (k < mine && M < 0) {")]),
    **{f"dense_{k}_{name}": (src, edits) for k, src in (("fwd", "spectral_contract.cu"),
                                                         ("bwd_x", "spectral_contract_bwd.cu"))
       for name, edits in _DENSE_STREAM_VARIANTS.items()},
    "dense_bwd_x_modes_fastest": ("spectral_contract_bwd.cu", [
        ("    n0 = (t % nnt) * TN;", "    m0 = (t % nmt) * TMD;"),
        ("    m0 = ((t / nnt) % nmt) * TMD;", "    n0 = ((t / nmt) % nnt) * TN;")]),
    "dense_bwd_x_unstaggered_widen_stores": ("spectral_contract_bwd.cu", [
        ("        *reinterpret_cast<float4*>(to + (s4 ? 4 : 0)) = s4 ? hi : lo;\n"
         "        *reinterpret_cast<float4*>(to + (s4 ? 0 : 4)) = s4 ? lo : hi;",
         "        *reinterpret_cast<float4*>(to) = lo;\n"
         "        *reinterpret_cast<float4*>(to + 4) = hi;")]),
    "dense_bwd_x_diag_no_widening": ("spectral_contract_bwd.cu", [
        ("        const uint4 v = *reinterpret_cast<const uint4*>(ddst(slot, j));",
         "        if (M > 0) continue;\n"
         "        const uint4 v = *reinterpret_cast<const uint4*>(ddst(slot, j));")]),
    "dense_bwd_w_64_mode_tiles": ("spectral_contract_bwd.cu", [
        ("constexpr int WTM = 16;", "constexpr int WTM = 64;"),
        ("constexpr int WTI = 32;", "constexpr int WTI = 16;"),
        ("constexpr int WTO = 32;", "constexpr int WTO = 16;")]),
    "dense_bwd_w_channels_fastest": ("spectral_contract_bwd.cu", [
        ("    m0 = (t % nmt) * WTM;", "    o0 = (t % nto) * WTO;"),
        ("    i0 = ((t / nmt) % nit) * WTI;", "    i0 = ((t / nto) % nit) * WTI;"),
        ("    o0 = (t / (nmt * nit)) * WTO;", "    m0 = (t / (nto * nit)) * WTM;")]),
    "dense_bwd_w_diag_no_stores": ("spectral_contract_bwd.cu", [
        ("        if (i >= I || oo >= O) continue;",
         "        if (i >= I || oo >= O || M > 0) continue;")]),
    "dense_bwd_w_diag_no_sums": ("spectral_contract_bwd.cu", [
        ("    for (int bb = 0; bb < nbv; ++bb) {",
         "    for (int bb = 0; bb < nbv && M < 0; ++bb) {")]),
    "dense_bwd_w_2_stages": ("spectral_contract_bwd.cu", [
        ("constexpr int WSTAGES = 3;", "constexpr int WSTAGES = 2;")]),
    "dense_bwd_w_4_stages": ("spectral_contract_bwd.cu", [
        ("constexpr int WSTAGES = 3;", "constexpr int WSTAGES = 4;")]),
    "dense_bwd_w_2_row_slots": ("spectral_contract_bwd.cu", [
        ("static constexpr int BT = sizeof(T) == 2 ? 8 : 4;", "static constexpr int BT = 2;")]),
    "dense_bwd_w_4_row_slots": ("spectral_contract_bwd.cu", [
        ("static constexpr int BT = sizeof(T) == 2 ? 8 : 4;", "static constexpr int BT = 4;")]),
    "dense_bwd_w_streaming_stores": ("spectral_contract_bwd.cu", [
        ("  *reinterpret_cast<float4*>(p) = v;", "  __stcs(reinterpret_cast<float4*>(p), v);")]),
    "fused_3xtf32": ("spectral_fused.cu", [
        (_FUSED_RUN_STEP, _FUSED_TF32 + _FUSED_RUN_STEP),
        ("uint32_t ap[MT][3][4];", "uint32_t ap[MT][4][4];"),
        ("split_a<MT>(a, ap);", "split_a_tf32<MT>(a, ap);"),
        ("products<MT, NTL>(hi, lo, ap, b,", "products_tf32<MT, NTL>(hi, lo, ap, b,")]),
    "fused_one_accumulator": ("spectral_fused.cu", [
        ("constexpr bool TWO_ACC = true;", "constexpr bool TWO_ACC = false;")]),
    "fused_one_accumulator_32x32": ("spectral_fused.cu", [
        ("constexpr bool TWO_ACC = true;", "constexpr bool TWO_ACC = false;"),
        ("constexpr int WARP_MT = 1, WARP_NT = 4;", "constexpr int WARP_MT = 2, WARP_NT = 4;")]),
    "fused_warp_tiles_32x32": ("spectral_fused.cu", [
        ("constexpr int WARP_MT = 1, WARP_NT = 4;", "constexpr int WARP_MT = 2, WARP_NT = 4;")]),
    "fused_warp_tiles_16x16": ("spectral_fused.cu", [
        ("constexpr int WARP_MT = 1, WARP_NT = 4;", "constexpr int WARP_MT = 1, WARP_NT = 2;")]),
    "fused_weights_1_channel_ahead": ("spectral_fused.cu", [
        ("constexpr int CT_AHEAD = 4;", "constexpr int CT_AHEAD = 1;")]),
    "fused_weights_8_channels_ahead": ("spectral_fused.cu", [
        ("constexpr int CT_AHEAD = 4;", "constexpr int CT_AHEAD = 8;")]),
    "fused_products_in_order": ("spectral_fused.cu", [
        ("  for (int p = 0; p < 6; ++p)\n#pragma unroll\n    for (int mt = 0; mt < MT; ++mt)\n"
         "#pragma unroll\n      for (int nt = 0; nt < NTL; ++nt)\n",
         "  for (int nt = 0; nt < NTL; ++nt)\n#pragma unroll\n    for (int mt = 0; mt < MT; ++mt)\n"
         "#pragma unroll\n      for (int p = 0; p < 6; ++p)\n")]),
    "fused_uncapped_registers": ("spectral_fused.cu", [
        ("constexpr int MINB = 2;", "constexpr int MINB = 1;")]),
    "fused_ct_4_modes": ("spectral_fused.cu", [
        ("constexpr int CT_T = 8;", "constexpr int CT_T = 4;")]),
    "fused_diag_no_transforms": ("spectral_fused.cu", [
        ("  for (int i = 0; i < D.nd; ++i) {\n    run_step",
         "  for (int i = 0; i < 0 * D.nd; ++i) {\n    run_step")]),
    "fused_diag_no_contraction": ("spectral_fused.cu", [
        ("  contract_fwd(xhr, xhi, wr, wi, yhr, yhi, D, cast, sm);\n", ""),
        ("  contract_bwd(xhr, xhi, ghr, ghi, wr, wi, dxr, dxi, dwr, dwi, D, cast, accumulate, sm);\n",
         "")]),
    "fused_diag_no_products": ("spectral_fused.cu", [
        ("        if (nt < nvalid)\n          mma16816",
         "        if (nt < nvalid && nvalid > (1 << 30))\n          mma16816")]),
    "fused_diag_no_factor_loads": ("spectral_fused.cu", [
        ("    for (int q = 0; q < 3; ++q) b[nt][q] = nt < nvalid ? fb[nt * 32 + q * piece] : uint2{};",
         "    for (int q = 0; q < 3; ++q) b[nt][q] = make_uint2(nt + q, nvalid);")]),
    "fused_diag_no_output_stores": ("spectral_fused.cu", [
        ("        float* p = o + part * s.oP + j * s.oJ;\n",
         "        float* p = o + part * s.oP + j * s.oJ;\n        if (s.oP == 0) continue;\n")]),
    "fused_products_in_order": ("spectral_fused.cu", [
        ("  for (int p = 0; p < 6; ++p)\n#pragma unroll\n    for (int mt = 0; mt < MT; ++mt)\n"
         "#pragma unroll\n      for (int nt = 0; nt < NTL; ++nt)\n",
         "  for (int nt = 0; nt < NTL; ++nt)\n#pragma unroll\n    for (int mt = 0; mt < MT; ++mt)\n"
         "#pragma unroll\n      for (int p = 0; p < 6; ++p)\n")]),
    "fused_diag_no_data_loads": ("spectral_fused.cu", [
        ("a[mt][h][e] = lv && roff[mt][h] >= 0 ? d[roff[mt][h] + l * s.dL] : 0.f;",
         "a[mt][h][e] = lv ? float(roff[mt][h] + l) : 0.f;")]),
    "fused_diag_no_transform_stores": ("spectral_fused.cu", [
        ("        float* p = o + part * s.oP + j * s.oJ;\n",
         "        float* p = o + part * s.oP + j * s.oJ;\n        if (s.cast >= 0) continue;\n")]),
    "rmsnorm_no_prefetch": ("rmsnorm.cu", [
        ("constexpr int PREFETCH_MAX_CH = 4;", "constexpr int PREFETCH_MAX_CH = 0;")]),
    "rmsnorm_prefetch_all": ("rmsnorm.cu", [
        ("constexpr int PREFETCH_MAX_CH = 4;", "constexpr int PREFETCH_MAX_CH = 8;")]),
}


def inlined(text, seen):
    """``text`` with each ``csrc/`` header it includes written out in its
    place, once."""
    def put(m):
        if m[1] in seen:
            return ""
        seen.add(m[1])
        return inlined((build.CSRC / m[1]).read_text().replace("#pragma once\n", ""), seen)
    return re.sub(r'^#include "(\w+\.cuh)"\n', put, text, flags=re.M)


def variant_source(name):
    shipped, edits = VARIANTS[name]
    text = inlined((build.CSRC / shipped).read_text(), set())
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the shipped {shipped} has no line {old!r}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def libraries(prefix, shipped, signature):
    """{name: ctypes library}: the shipped source, then its variants."""
    paths = {"shipped": build.CSRC / shipped}
    paths.update({n: variant_source(n) for n, (src, _) in VARIANTS.items()
                  if n.startswith(prefix + "_")})
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(build.build, paths.values()))
    return {n: build._bind(p, **signature) for n, p in paths.items()}


def flash_trials():
    libs = libraries("flash", "flash_attention.cu", {"flash_attention_fwd": (4, 7, 1)})

    def run(lib, q, k, v):
        BH, S, D = q.shape
        out = torch.empty_like(q)
        build._call(lib.flash_attention_fwd, "flash_attention_fwd", q.device, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, k.shape[1], D, 128, 1,
                    fa._FMT[q.dtype], 1.0 / D ** 0.5)
        return out

    order = list(libs) + list(reversed(libs))
    for tag, BH, S, D in cs.FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float16):
            g = torch.Generator(device="cuda").manual_seed(cs.SEED + 60)
            q, k, v = (torch.randn(BH, S, D, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            plain = fa.flash_attention_plain(q, k, v, causal=True)
            pick = torch.linspace(0, S - 1, cs.FLASH_ORACLE_ROWS, device="cuda").long()
            limit = 0.25 * cs.rel_l2_dev(plain[:, pick], cs.flash_rows_oracle(q, k, v, pick))
            row = {"kernel": "flash_attention_fwd", "config": tag, "dtype": str(dtype),
                   "limit": limit, "ms": {}, "rel_l2": {}}
            for name in order:
                got = run(libs[name], q, k, v)
                row["rel_l2"][name] = cs.rel_l2_dev(got[:, pick], plain[:, pick])
                row["ms"].setdefault(name, []).append(
                    cs.event_ms(lambda *a, n=name: run(libs[n], *a), [(q, k, v)], 3))
                del got
            print(json.dumps(row), flush=True)
            del q, k, v, plain
            torch.cuda.empty_cache()


def ls_bwd_w_trials():
    libs = libraries("ls_bwd_w", "spectral_contract_lshared.cu",
                     {"spectral_contract_ls_bwd_w": (6, 6)})
    B, I, O, L, M = cs.LS_PATH_SHAPE
    order = list(libs) + list(reversed(libs))
    for dtype in (torch.bfloat16, torch.float32):
        sets = [cs.ls_operands(cs.LS_PATH_SHAPE, dtype, 400 + k) for k in range(4)]

        def run(lib, xr, xi, wr, wi, gr, gi):
            dwr = torch.empty((I, O, L), dtype=dtype, device="cuda")
            dwi = torch.empty_like(dwr)
            build._call(lib.spectral_contract_ls_bwd_w, "spectral_contract_ls_bwd_w",
                        xr.device, *(t.data_ptr() for t in (xr, xi, gr, gi, dwr, dwi)),
                        B, I, O, L, M, sc._FMT[dtype])
            return dwr, dwi

        xr, xi, _, _, gr, gi = sets[0]
        want = sc.spectral_contract_lshared_bwd_w_plain(xr, xi, gr, gi)
        row = {"kernel": "spectral_contract_ls_bwd_w", "shape": list(cs.LS_PATH_SHAPE),
               "dtype": str(dtype), "us": {}, "max_abs_diff": {}}
        for name in order:
            got = run(libs[name], *sets[0])
            row["max_abs_diff"][name] = max((a.float() - b.float()).abs().max().item()
                                            for a, b in zip(got, want, strict=True))
            row["us"].setdefault(name, []).append(
                1e3 * cs.graph_ms(lambda *a, n=name: run(libs[n], *a), sets))
        print(json.dumps(row), flush=True)


def ls_mix_trials():
    sig = {"spectral_contract_ls_fwd": (6, 8), "spectral_contract_ls_bwd_x": (6, 8)}
    libs = libraries("ls_mix", "spectral_contract_lshared.cu", sig)
    B, I, O, L, M = cs.LS_PATH_SHAPE
    # (library, weight resident, splits)
    runs = {n: (n, 1, 1) for n in libs}
    runs.update({"shipped_w_streamed": ("shipped", 0, 1), "shipped_2_splits": ("shipped", 1, 2)})
    order = list(runs) + list(reversed(runs))
    for dtype in (torch.bfloat16, torch.float32):
        sets = [cs.ls_operands(cs.LS_PATH_SHAPE, dtype, 400 + k) for k in range(4)]
        for fn, plain in (("spectral_contract_ls_fwd", sc.spectral_contract_lshared_plain),
                          ("spectral_contract_ls_bwd_x",
                           sc.spectral_contract_lshared_bwd_x_plain)):
            bwd = fn.endswith("bwd_x")

            def run(name, xr, xi, wr, wi, gr, gi, fn=fn, bwd=bwd):
                lib, wres, splits = runs[name]
                out = [torch.empty((B, I if bwd else O, L, M), dtype=dtype, device="cuda")
                       for _ in range(2)]
                a = (gr, gi) if bwd else (xr, xi)
                build._call(getattr(libs[lib], fn), fn, xr.device,
                            *(t.data_ptr() for t in (*a, wr, wi, *out)),
                            B, I, O, L, M, wres, splits, sc._FMT[dtype])
                return out

            xr, xi, wr, wi, gr, gi = sets[0]
            want = plain(gr, gi, wr, wi) if bwd else plain(xr, xi, wr, wi)
            row = {"kernel": fn, "shape": list(cs.LS_PATH_SHAPE), "dtype": str(dtype),
                   "us": {}, "max_abs_diff": {}}
            for name in order:
                got = run(name, *sets[0])
                row["max_abs_diff"][name] = max((a.float() - b.float()).abs().max().item()
                                                for a, b in zip(got, want, strict=True))
                row["us"].setdefault(name, []).append(
                    1e3 * cs.graph_ms(lambda *a, n=name: run(n, *a), sets))
            print(json.dumps(row), flush=True)
        del sets
        torch.cuda.empty_cache()


def rmsnorm_trials():
    libs = libraries("rmsnorm", "rmsnorm.cu", {"rmsnorm_fwd": (3, 8, 1)})
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 60)
    for N, D in cs.RMS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(N, D, generator=g, device="cuda").to(dtype)
            w = (torch.rand(D, generator=g, device="cuda") + 0.5).to(dtype)
            p = rn.rmsnorm_plan(D, dtype, dtype)
            plan = (p.vec, p.chunks, p.warps_per_row)
            size = x.element_size()
            vec_units = D // (16 // size)
            # (library, (vec, chunks, warps a row, waves))
            runs = {"shipped": ("shipped", (*plan, p.waves))}
            for waves in (1, 2, 4, 0):
                runs[f"plan_{waves}_waves"] = ("shipped", (*plan, waves))
                for lib in ("rmsnorm_no_prefetch", "rmsnorm_prefetch_all"):
                    runs[f"{lib}_{waves}_waves"] = (lib, (*plan, waves))
            q = rn.rmsnorm_plan(D, dtype, dtype, False)
            runs["one_element_a_lane"] = ("shipped", (q.vec, q.chunks, q.warps_per_row, q.waves))
            for wpr in (1, 2, 4, 8):
                per = -(-vec_units // (32 * wpr))
                for chunks in (2, 4, 8):
                    if chunks >= per and (True, chunks, wpr) != plan and chunks <= 2 * per:
                        for waves in (1, 0):
                            runs[f"vec_{chunks}_packs_{wpr}_warps_{waves}_waves"] = (
                                "shipped", (True, chunks, wpr, waves))
            want = rn.rmsnorm_plain(x, w)

            def run(name, x, w):
                lib, (vec, chunks, wpr, waves) = runs[name]
                y = torch.empty_like(x)
                build._call(libs[lib].rmsnorm_fwd, "rmsnorm_fwd", x.device, x.data_ptr(),
                            w.data_ptr(), y.data_ptr(), N, D, rn._FMT[dtype], rn._FMT[dtype],
                            int(vec), chunks, wpr, waves, 1e-6)
                return y

            order = list(runs) + list(reversed(runs))
            row = {"kernel": "rmsnorm_fwd", "shape": [N, D], "dtype": str(dtype),
                   "plans": {n: list(p) for n, (_, p) in runs.items()}, "us": {},
                   "bit_equal_share": {}, "library_us": []}
            for k, name in enumerate(order):
                row["bit_equal_share"][name] = (run(name, x, w) == want).float().mean().item()
                row["us"].setdefault(name, []).append(
                    1e3 * cs.graph_ms(lambda *a, n=name: run(n, *a), [(x, w)], 20))
                if k in (0, len(order) - 1):   # F.rms_norm, the yardstick, in the same turns
                    row["library_us"].append(1e3 * cs.graph_ms(
                        lambda x, w: torch.nn.functional.rms_norm(x, (D,), w, 1e-6),
                        [(x, w)], 20))
            print(json.dumps(row), flush=True)
            del x, w, want
            torch.cuda.empty_cache()


def interleaved_us(fn, sets, other):
    """µs per call of ``fn`` when each call follows ``other()`` (another
    kernel, as on the paths, where cuFFT and elementwise kernels run between
    launches): a CUDA graph of both in turns, less one of ``other`` alone."""
    both = cs.graph_ms(lambda *a: (other(), fn(*a)), sets)
    return 1e3 * (both - cs.graph_ms(lambda *a: other(), sets))


def fft_between():
    """A cuFFT transform of the TFNO path's 128² activations (8 x 64
    fields), the kernel that precedes the spectral contraction there."""
    x = torch.randn(8, 64, 128, 128, device="cuda")
    return lambda: torch.fft.rfft2(x)


def cp_fwd_trials():
    libs = libraries("cp_fwd", "spectral_contract_cp.cu", {"spectral_contract_cp_fwd": (10, 7)})
    B, I, O, R, M = cs.CP_PATH_SHAPE
    other = fft_between()
    order = list(libs) + list(reversed(libs))
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        sets = [cs.cp_operands(cs.CP_PATH_SHAPE, dtype, 300 + k)[:8] for k in range(8)]
        plan = sc.cp_fwd_plan(I, O, R, dtype)

        def run(name, *ops, dtype=dtype, plan=plan):
            out = [torch.empty((B, O, M), dtype=dtype, device="cuda") for _ in range(2)]
            build._call(libs[name].spectral_contract_cp_fwd, "spectral_contract_cp_fwd",
                        ops[0].device, *(t.data_ptr() for t in (*ops, *out)),
                        B, I, O, R, M, int(plan.resident), sc._FMT[dtype])
            return out

        want = sc.spectral_contract_cp_plain(*sets[0])
        mag = sc.cp_magnitudes(*sets[0])["out"]
        eps = FORMAT_EPS[dtype_name(dtype)]
        row = {"kernel": "spectral_contract_cp_fwd", "shape": list(cs.CP_PATH_SHAPE),
               "dtype": str(dtype), "us": {}, "excess_over_budget": {}}
        for name in order:
            got = run(name, *sets[0])
            row["excess_over_budget"][name] = max(
                ((a.float() - b.float()).abs() - store_budget(eps, b.float(), mag)).max().item()
                for a, b in zip(got, want, strict=True))
            row["us"].setdefault(name, []).append(
                1e3 * cs.graph_ms(lambda *a, n=name: run(n, *a), sets))
            row.setdefault("after_fft_us", {}).setdefault(name, []).append(
                interleaved_us(lambda *a, n=name: run(n, *a), sets, other))
        csets = [[torch.complex(o[2 * k].float(), o[2 * k + 1].float()) for k in range(4)]
                 for o in sets]
        row["library_us"] = 1e3 * cs.graph_ms(
            lambda x, ui, uo, w: torch.einsum("bim,ir,rm,or->bom", x, ui, w, uo), csets)
        print(json.dumps(row), flush=True)
        del sets, csets
        torch.cuda.empty_cache()


def dense_bwd_w_trials():
    libs = libraries("dense_bwd_w", "spectral_contract_bwd.cu",
                     {"spectral_contract_dense_bwd_w": (6, 6)})
    B, I, O, M = cs.PATH_SHAPE
    order = list(libs) + list(reversed(libs))
    sets = [cs.operands(cs.PATH_SHAPE, 100 + k) for k in range(4)]
    other = fft_between()
    for cast_to, dt in ((torch.bfloat16, torch.bfloat16), (None, torch.float32)):
        full = [(xr, xi, *cs.cotangent(cs.PATH_SHAPE, dt, 200 + k))
                for k, (xr, xi, _, _) in enumerate(sets)]

        def run(name, xr, xi, gr, gi, cast_to=cast_to):
            dw = [torch.empty((I, O, M), device="cuda") for _ in range(2)]
            build._call(libs[name].spectral_contract_dense_bwd_w, "spectral_contract_dense_bwd_w",
                        xr.device, *(t.data_ptr() for t in (xr, xi, gr, gi, *dw)),
                        B, I, O, M, sc._FMT[cast_to or torch.float32], sc._FMT[gr.dtype])
            return dw

        want = sc.spectral_contract_bwd_w_plain(*full[0], cast_to=cast_to)
        row = {"kernel": "spectral_contract_dense_bwd_w", "shape": list(cs.PATH_SHAPE),
               "mode": str(dt), "us": {}, "max_abs_diff": {}}
        for name in order:
            try:
                got = run(name, *full[0])
            except RuntimeError as err:     # a ring that does not fit shared memory
                row["us"][name], row["max_abs_diff"][name] = None, str(err)
                continue
            row["max_abs_diff"][name] = max((a - b).abs().max().item()
                                            for a, b in zip(got, want, strict=True))
            row["us"].setdefault(name, []).append(
                1e3 * cs.graph_ms(lambda *a, n=name: run(n, *a), full))
            row.setdefault("after_fft_us", {}).setdefault(name, []).append(
                interleaved_us(lambda *a, n=name: run(n, *a), full, other))
        gc = [torch.complex(*cs.cotangent(cs.PATH_SHAPE, torch.float32, 200 + k))
              for k in range(4)]
        xs = [torch.complex(xr, xi) for xr, xi, _, _ in sets]
        row["library_us"] = 1e3 * cs.graph_ms(
            lambda x, g: torch.einsum("bim,bom->iom", x.conj(), g), list(zip(xs, gc)))
        print(json.dumps(row), flush=True)


def kernel_profile(fn, reps=10):
    """{kernel name: mean device µs a launch} of ``fn``'s launches under
    ``torch.profiler`` (each kernel of a two-launch wrapper apart)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and e.count:
            out[e.key[:60]] = t / e.count
    return out


def cp_bwd_trials():
    libs = libraries("cp_bwd", "spectral_contract_cp.cu", {"spectral_contract_cp_bwd": (19, 9)})
    for lib in libs.values():
        lib.spectral_contract_cp_bwd_workspace.argtypes = [ctypes.c_int] * 6
        lib.spectral_contract_cp_bwd_workspace.restype = ctypes.c_longlong
    B, I, O, R, M = cs.CP_PATH_SHAPE
    order = list(libs) + list(reversed(libs))
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        sets = [cs.cp_operands(cs.CP_PATH_SHAPE, dtype, 300 + k) for k in range(8)]
        plan = sc.cp_bwd_plan(I, O, R, dtype)
        work = {n: torch.empty(int(lib.spectral_contract_cp_bwd_workspace(
            B, I, O, R, M, sc._FMT[dtype])), device="cuda") for n, lib in libs.items()}

        def run(name, *ops, dtype=dtype, plan=plan):
            grads = [torch.empty_like(t) for t in ops[:8]]
            build._call(libs[name].spectral_contract_cp_bwd, "spectral_contract_cp_bwd",
                        ops[0].device, *(t.data_ptr() for t in (*ops, *grads, work[name])),
                        B, I, O, R, M, plan.IC, plan.OC, int(plan.acc_smem), sc._FMT[dtype])
            return grads

        want = sc.spectral_contract_cp_bwd_plain(*sets[0])
        mags = sc.cp_magnitudes(*sets[0])
        names = ("dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o", "dW", "dW")
        eps = FORMAT_EPS[dtype_name(dtype)]
        row = {"kernel": "spectral_contract_cp_bwd", "shape": list(cs.CP_PATH_SHAPE),
               "dtype": str(dtype), "us": {}, "excess_over_budget": {}}
        for name in order:
            got = run(name, *sets[0])
            row["excess_over_budget"][name] = max(
                ((a.float() - b.float()).abs()
                 - store_budget(eps, b.float(), mags[k])).max().item()
                for a, b, k in zip(got, want, names, strict=True))
            row["us"].setdefault(name, []).append(
                1e3 * cs.graph_ms(lambda *a, n=name: run(n, *a), sets))
        row["profile_us"] = kernel_profile(lambda: run("shipped", *sets[0]))
        print(json.dumps(row), flush=True)
        del sets, work
        torch.cuda.empty_cache()


def dense_fwd_trials():
    libs = libraries("dense_fwd", "spectral_contract.cu", {"spectral_contract_dense_fwd": (6, 6)})
    B, I, O, M = cs.PATH_SHAPE
    order = list(libs) + list(reversed(libs))
    sets = [cs.operands(cs.PATH_SHAPE, 100 + k) for k in range(4)]
    for cast_to, dt in ((torch.bfloat16, torch.bfloat16), (None, torch.float32)):

        def run(name, xr, xi, wr, wi, cast_to=cast_to, dt=dt):
            out = [torch.empty((B, O, M), dtype=dt, device="cuda") for _ in range(2)]
            build._call(libs[name].spectral_contract_dense_fwd, "spectral_contract_dense_fwd",
                        xr.device, *(t.data_ptr() for t in (xr, xi, wr, wi, *out)),
                        B, I, O, M, sc._FMT[cast_to or torch.float32], sc._FMT[dt])
            return out

        want = sc.spectral_contract_plain(*sets[0], cast_to=cast_to, out_dtype=dt)
        row = {"kernel": "spectral_contract_dense_fwd", "shape": list(cs.PATH_SHAPE),
               "mode": str(dt), "us": {}, "max_abs_diff": {}, "bits_equal_shipped": {}}
        first = run("shipped", *sets[0])
        for name in order:
            got = run(name, *sets[0])
            row["max_abs_diff"][name] = max((a.float() - b.float()).abs().max().item()
                                            for a, b in zip(got, want, strict=True))
            row["bits_equal_shipped"][name] = all(
                torch.equal(a, b) for a, b in zip(got, first, strict=True))
            row["us"].setdefault(name, []).append(
                1e3 * cs.graph_ms(lambda *a, n=name: run(n, *a), sets))
        print(json.dumps(row), flush=True)


def dense_bwd_x_trials():
    libs = libraries("dense_bwd_x", "spectral_contract_bwd.cu",
                     {"spectral_contract_dense_bwd_x": (6, 6)})
    B, I, O, M = cs.PATH_SHAPE
    order = list(libs) + list(reversed(libs))
    sets = [cs.operands(cs.PATH_SHAPE, 100 + k) for k in range(4)]
    for cast_to, dt in ((torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
                        (None, torch.float32)):
        full = [(*cs.cotangent(cs.PATH_SHAPE, dt, 200 + k), wr, wi)
                for k, (_, _, wr, wi) in enumerate(sets)]

        def run(name, gr, gi, wr, wi, cast_to=cast_to):
            dx = [torch.empty((B, I, M), device="cuda") for _ in range(2)]
            build._call(libs[name].spectral_contract_dense_bwd_x, "spectral_contract_dense_bwd_x",
                        gr.device, *(t.data_ptr() for t in (gr, gi, wr, wi, *dx)),
                        B, I, O, M, sc._FMT[cast_to or torch.float32], sc._FMT[gr.dtype])
            return dx

        want = sc.spectral_contract_bwd_x_plain(*full[0], cast_to=cast_to)
        row = {"kernel": "spectral_contract_dense_bwd_x", "shape": list(cs.PATH_SHAPE),
               "mode": str(dt), "us": {}, "max_abs_diff": {}, "bits_equal_shipped": {}}
        first = run("shipped", *full[0])
        for name in order:
            got = run(name, *full[0])
            row["max_abs_diff"][name] = max((a - b).abs().max().item()
                                            for a, b in zip(got, want, strict=True))
            row["bits_equal_shipped"][name] = all(
                torch.equal(a, b) for a, b in zip(got, first, strict=True))
            row["us"].setdefault(name, []).append(
                1e3 * cs.graph_ms(lambda *a, n=name: run(n, *a), full))
        gc = [torch.complex(*(g.float() for g in gs[:2])) for gs in full]
        ws = [torch.complex(wr, wi) for _, _, wr, wi in sets]
        row["library_us"] = 1e3 * cs.graph_ms(
            lambda g, w: torch.einsum("bom,iom->bim", g, w.conj()), list(zip(gc, ws)))
        print(json.dumps(row), flush=True)


def fused_trials():
    libs = libraries("fused", "spectral_fused.cu",
                     {"spectral_fused_fwd": (6, 12), "spectral_fused_bwd": (9, 13)})
    order = list(libs) + list(reversed(libs))
    for grid, iters in ((128, 20), (421, 10)):
        B, I, O, spatial, modes = shape = (8, 64, 64, (grid, grid), (32, 32))
        sets = [cs.fused_operands(shape, 500 + k) for k in range(2)]
        x0, wr0, wi0, g0 = sets[0]
        pack = sc._fused_pack(spatial, modes, x0.device)
        scratch = torch.empty(sc.fused_scratch_bytes(B, I, O, spatial, modes) // 4,
                              device=x0.device)
        axes = sc._fused_args(x0, modes)
        mags = sc.fused_magnitude(x0, wr0, wi0, modes, g=g0)
        mags = (mags["out"], mags["dx"], mags["dw"], mags["dw"])
        raw = (sc.spectral_fused_plain(x0, wr0, wi0, modes),
               *sc.spectral_fused_bwd_plain(x0, wr0, wi0, g0, modes))
        for cast_to in (torch.bfloat16, torch.float16, None):
            mode = sc._FMT[cast_to or torch.float32]

            def fwd(name, x, wr, wi, _g, mode=mode):
                y = torch.empty((B, O, *spatial), device=x.device)
                build._call(libs[name].spectral_fused_fwd, "spectral_fused_fwd", x.device,
                            *(t.data_ptr() for t in (x, wr, wi, pack, y, scratch)), B, I, O,
                            *axes, mode, 0)
                return y

            def bwd(name, x, wr, wi, g, mode=mode):
                dx, dwr, dwi = torch.empty_like(x), torch.empty_like(wr), torch.empty_like(wi)
                build._call(libs[name].spectral_fused_bwd, "spectral_fused_bwd", x.device,
                            *(t.data_ptr() for t in (x, wr, wi, pack, g, dx, dwr, dwi, scratch)),
                            B, I, O, *axes, mode, 0, 0)
                return dx, dwr, dwi

            want = (sc.spectral_fused_plain(x0, wr0, wi0, modes, cast_to=cast_to),
                    *sc.spectral_fused_bwd_plain(x0, wr0, wi0, g0, modes, cast_to=cast_to))
            eps = FORMAT_EPS[dtype_name(cast_to or torch.float32)]
            row = {"kernel": "spectral_fused", "shape": [B, I, O, list(spatial), list(modes)],
                   "mode": str(cast_to or torch.float32), "fwd_us": {}, "bwd_us": {},
                   "excess_over_budget": {}, "rel_l2_excess": {}}
            for name in order:
                got = (fwd(name, *sets[0]), *bwd(name, *sets[0]))
                torch.cuda.synchronize()
                excess, gap_excess = [], []
                for a, b, r, mag, stages in zip(got, want, raw, mags, (2, 4, 4, 4), strict=True):
                    budget = contract_budget(eps, mag, stages=stages)
                    excess.append(((a.double() - b.double()).abs() - budget).max().item())
                    if cast_to is not None:
                        gap_excess.append(cs.rel_l2_dev(a, b) - 0.25 * cs.rel_l2_dev(b, r))
                row["excess_over_budget"][name] = max(excess)
                if gap_excess:
                    row["rel_l2_excess"][name] = max(gap_excess)
                del got
                for key, fn in (("fwd_us", fwd), ("bwd_us", bwd)):
                    row[key].setdefault(name, []).append(
                        1e3 * cs.event_ms(lambda *a, n=name, fn=fn: fn(n, *a), sets, iters))
            print(json.dumps(row), flush=True)
        del sets, scratch, raw, mags
        torch.cuda.empty_cache()


TRIALS = {"flash": flash_trials, "ls_bwd_w": ls_bwd_w_trials, "ls_mix": ls_mix_trials,
          "rmsnorm": rmsnorm_trials, "cp_fwd": cp_fwd_trials, "dense_bwd_w": dense_bwd_w_trials,
          "fused": fused_trials, "cp_bwd": cp_bwd_trials, "dense_fwd": dense_fwd_trials,
          "dense_bwd_x": dense_bwd_x_trials}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(TRIALS))
    args = ap.parse_args()
    names = args.only.split(",")
    if any(n not in TRIALS for n in names):
        ap.error(f"trials are {list(TRIALS)}, got {names}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trials: needs an NVIDIA GPU")
    OUT.mkdir(parents=True, exist_ok=True)
    cs.device_phase()
    for name in names:
        TRIALS[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
