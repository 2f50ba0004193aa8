#!/usr/bin/env python3
"""Try variants of hand-written kernels beside the shipped ones on one GPU.

    python3 tools/kernel_trials.py [--only flash,ls_bwd_w,ls_mix,rmsnorm]

Each variant is the shipped source with a few lines replaced (``VARIANTS``),
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
  instance; ``F.rms_norm`` timed the same way first and last.

Needs one card.
"""
import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import spectral_contract as sc  # noqa: E402

OUT = ROOT / "build" / "kernel_trials"
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
    "rmsnorm_no_prefetch": ("rmsnorm.cu", [
        ("constexpr int PREFETCH_MAX_CH = 4;", "constexpr int PREFETCH_MAX_CH = 0;")]),
    "rmsnorm_prefetch_all": ("rmsnorm.cu", [
        ("constexpr int PREFETCH_MAX_CH = 4;", "constexpr int PREFETCH_MAX_CH = 8;")]),
}


def variant_source(name):
    shipped, edits = VARIANTS[name]
    text = (build.CSRC / shipped).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the shipped {shipped} has no line {old!r}")
        text = text.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    for header in build.CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
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


TRIALS = {"flash": flash_trials, "ls_bwd_w": ls_bwd_w_trials, "ls_mix": ls_mix_trials,
          "rmsnorm": rmsnorm_trials}


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
