"""End-to-end serve smoke: drive a small LM engine, a small paged LM
engine and a small FNO engine and record their ``stats()``.

A real engine run whose artifact records the resolved precision site
table *and* each engine's own accounting — tokens/s or fields/s, slot
occupancy, queue wait, admission counters, the paged pool and prefix
index, the operator memo — so the serving path is tracked run to run.
On the GPU unless ``--device`` names another:

    PYTHONPATH=src python -m repro_torch.launch.serve_smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_smoke --device cpu --out build/s.json
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_fno
from repro_torch.models.lm import init_lm
from repro_torch.precision import describe, get_policy
from repro_torch.serve import (
    FieldRequest,
    LMEngine,
    OperatorEngine,
    PagedLMEngine,
    Request,
    SamplingParams,
)

RESULTS = str(Path(__file__).resolve().parents[3] / "build" / "serve_smoke.json")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"serve smoke: {what}")


def run_lm_smoke(policy_name: str = "full", device: DeviceLike = None) -> dict:
    cfg = get_config("smollm-360m", smoke=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device=device)
    policy = get_policy(policy_name)
    engine = LMEngine(params, cfg, n_slots=2, max_len=64, policy=policy,
                      scheduler="spf", prefill_chunk=8, seed=0, device=device)
    rng = np.random.RandomState(0)
    reqs = [
        Request(uid=i,
                prompt=[int(t) for t in rng.randint(1, cfg.vocab, rng.randint(3, 12))],
                max_new_tokens=6,
                sampling=SamplingParams(temperature=0.7, top_p=0.9)
                if i % 2 else SamplingParams())
        for i in range(6)
    ]
    # one oversized request proves the failure path stays accounted
    reqs.append(Request(uid=99, prompt=[1] * 100, max_new_tokens=10))
    for r in reqs:
        engine.submit(r)
    finished, _ = engine.drain(max_ticks=500)
    _check(sum(r.status == "done" for r in finished) == 6, f"LM engine finished {finished}")
    _check(sum(r.status == "failed" for r in finished) == 1, "the oversized request did not fail")
    return {"arch": cfg.name, "policy": policy_name,
            "policy_sites": describe(policy), "stats": engine.stats()}


def run_paged_lm_smoke(policy_name: str = "full", device: DeviceLike = None) -> dict:
    """Paged engine over repeated-prefix prompts: the artifact must show
    prefix hits (shared blocks doing real work) and a greedy stream
    identical to the dense engine's."""
    cfg = get_config("smollm-360m", smoke=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device=device)
    policy = get_policy(policy_name)
    rng = np.random.RandomState(0)
    shared = [int(t) for t in rng.randint(1, cfg.vocab, 16)]

    def mk():
        rng2 = np.random.RandomState(7)
        return [Request(uid=i, prompt=shared + [int(t) for t in rng2.randint(1, cfg.vocab, 2)],
                        max_new_tokens=4) for i in range(6)]

    engine = PagedLMEngine(params, cfg, n_slots=2, max_len=32, policy=policy,
                           prefill_chunk=8, block_size=8, device=device)
    finished, _ = engine.run_until_done(mk())
    _check(all(r.status == "done" for r in finished), f"paged engine finished {finished}")
    dense = LMEngine(params, cfg, n_slots=2, max_len=32, policy=policy, prefill_chunk=8,
                     device=device)
    d_finished, _ = dense.run_until_done(mk())
    _check({r.uid: r.generated for r in finished} == {r.uid: r.generated for r in d_finished},
           "paged and dense generations differ")
    stats = engine.stats()
    _check(stats["paged"]["prefix"]["hits"] > 0, f"no prefix hit: {stats['paged']}")
    _check(stats["prompt_tokens"] < dense.stats()["prompt_tokens"],
           "prefix sharing skipped no prefill")
    return {"arch": cfg.name, "policy": policy_name, "stats": stats}


def run_operator_smoke(policy_name: str = "mixed_fno_bf16", device: DeviceLike = None) -> dict:
    cfg = FNO_DARCY_SMOKE
    net = init_fno(torch.Generator().manual_seed(1), cfg, device=device)
    policy = get_policy(policy_name)
    engine = OperatorEngine(net, model="fno", policy=policy, max_batch=4, memo_window=8,
                            device=device)
    rng = np.random.RandomState(1)
    reqs = [FieldRequest(uid=i, x=rng.randn(1, 16, 16).astype(np.float32)) for i in range(5)]
    reqs += [FieldRequest(uid=10 + i, x=rng.randn(1, 32, 32).astype(np.float32))
             for i in range(3)]
    # a repeat of an already-served field: the content-hash memo must
    # answer it without recompute (the counter lands in the artifact)
    reqs.append(FieldRequest(uid=20, x=np.array(reqs[0].x, copy=True)))
    for r in reqs:
        engine.submit(r)
    finished, _ = engine.drain(max_ticks=50)
    _check(all(r.status == "done" for r in finished), f"operator engine finished {finished}")
    repeat = next(r for r in finished if r.uid == 20)
    _check(np.array_equal(repeat.y, reqs[0].y), "the memo's answer differs from the computed one")
    _check(engine.stats()["memo"]["hits"] >= 1, "the repeated field missed the memo")
    return {"arch": "fno-darcy-smoke", "policy": policy_name,
            "policy_sites": describe(policy), "stats": engine.stats()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--lm-policy", default="full")
    ap.add_argument("--operator-policy", default="mixed_fno_bf16")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--obs-trace", default=None, metavar="OUT_JSONL",
                    help="enable repro_torch.obs tracing across the three engine runs and "
                         "write the timeline + metrics snapshot as JSONL (plus "
                         "<stem>.trace.json and <stem>.prom)")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))

    from repro_torch.obs import trace, write_result

    if args.obs_trace:
        trace.enable()
    rec = {
        "lm": run_lm_smoke(args.lm_policy, dev),
        "lm_paged": run_paged_lm_smoke(args.lm_policy, dev),
        "operator": run_operator_smoke(args.operator_policy, dev),
    }
    write_result(args.out, rec, device=dev)
    print(json.dumps(rec, indent=1))
    print(f"\nserve smoke ok -> {args.out}")

    if args.obs_trace:
        from repro_torch.obs import (registry, run_records, write_chrome_trace, write_jsonl,
                                     write_prometheus)

        recs = trace.snapshot()
        snap = registry().snapshot()
        write_jsonl(args.obs_trace, run_records(recs, snapshot=snap, device=dev,
                                                run="serve_smoke"))
        stem = os.path.splitext(args.obs_trace)[0]
        write_chrome_trace(stem + ".trace.json", recs)
        write_prometheus(stem + ".prom", snap)
        print(f"obs: {len(recs)} trace records -> {args.obs_trace} "
              f"(+ {stem}.trace.json, {stem}.prom)")
    return rec


if __name__ == "__main__":
    main()
