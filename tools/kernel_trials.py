#!/usr/bin/env python3
"""Try variants of two hand-written kernels beside the shipped ones on one GPU.

    python3 tools/kernel_trials.py

Each variant is the shipped source with a few lines replaced (``VARIANTS``).
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
  than L2) and its largest difference from the plain version.

Needs one card.
"""
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
                  if n.startswith(prefix)})
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trials: needs an NVIDIA GPU")
    OUT.mkdir(parents=True, exist_ok=True)
    cs.device_phase()
    flash_trials()
    ls_bwd_w_trials()
    return 0


if __name__ == "__main__":
    sys.exit(main())
