"""``repro_torch.analyze``, the port's static numerics & precision linter,
on the CPU: the counterpart of each applicable case of
``tests/test_analyze.py``, plus what only the port has.

* Seeded violations: a bf16 contraction accumulating at bf16 in a
  ``*/spectral/contract`` scope, the same outside one, an unstabilised
  fp16 ``exp``, a round-trip cast, a demoted contract site that never
  touches its half dtype, a half-accumulating ``_einsum_half``: each fires
  its check with the reference's slug and severity.  The widen-then-multiply
  reading (a widened half read as its half dtype, accumulation = the
  output dtype, a round trip into contractions only is no round trip) and
  a kernel launch record counting toward ``fp32-resident`` are held too,
  and backward ops land on the forward site that made them.
* Sites, launch plans (the launch recorder on CPU tensors, which plans and
  launches nothing), calibration states and suppressions; the CLI writes
  its report and exits 0 with ``--device cpu``.
* The clean tree: every policy x model x path and the trainer step give no
  unsuppressed error.
* Parity with the reference where it still runs on this JAX: the rule
  tables' findings, ``_is_recognized`` over both trees' literals and
  seeded ones, and ``calibration_pass`` on corrupt and non-power-of-two
  entries.  Golden parity: for the 8 policies the port's staged
  ``dtype_trace`` projects (``dataflow.project``) onto the golden's ``""``
  and ``+pallas`` keys, the fused one onto ``+fused``; the projection
  fails for a half-accumulating contraction and a skipped quantize.
* Scope wiring: a forward and a trainer step of FNO, TFNO and SFNO give
  bit-identical outputs and gradients with the recorder on, off, and with
  no scope at all.
"""
import json
import os
import textwrap

import numpy as np
import pytest
import torch

import repro.analyze.kernels as jkernels
import repro.analyze.sites as jsites
from repro.precision.rules import SiteRule as JSiteRule
from repro_torch.analyze import (
    ERROR,
    WARNING,
    Finding,
    Suppression,
    dedupe,
    dtype_trace,
    kernels_pass,
    load_suppressions,
    model_findings,
    partition,
    project,
    recording,
    rule_table_findings,
    shadowed_entries,
    site_universe,
    sites_pass,
    trace_findings,
    trainer_findings,
)
from repro_torch.analyze import dataflow as df
from repro_torch.analyze import kernels as tkernels
from repro_torch.analyze import sites as tsites
from repro_torch.analyze.__main__ import DEFAULT_SUPPRESSIONS
from repro_torch.analyze.__main__ import main as analyze_main
from repro_torch.core import contraction
from repro_torch.kernels import spectral_contract as sc
from repro_torch.kernels.build import LaunchIO
from repro_torch.precision import POLICIES, SitePrecision, get_policy, site_scope
from repro_torch.precision.rules import SiteRule

_SRC = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "src"))
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dtype_traces.json")
SITE = "fno/layer2/spectral/contract"


def _normal(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _lint(fn, *args, policy="full"):
    return trace_findings(fn, args, get_policy(policy), "seeded")


# ---------------------------------------------------------------------------
# Seeded violations: the recorder must catch these
# ---------------------------------------------------------------------------


class TestSeededDataflowViolations:
    def test_bf16_contraction_without_f32_accum_is_an_error(self):
        def bad(x, w):
            with site_scope(SITE):
                return x.to(torch.bfloat16) @ w.to(torch.bfloat16)

        hits = [f for f in _lint(bad, _normal(4, 8), _normal(8, 4, seed=1))
                if f.check == "half-accum-contract"]
        assert len(hits) == 1
        f = hits[0]
        assert (f.severity, f.site, f.where) == (ERROR, SITE, "seeded")
        assert "bfloat16" in f.detail

    def test_f32_accumulation_in_contract_scope_is_clean(self):
        def good(x, w):
            with site_scope(SITE):
                return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()

        findings = _lint(good, _normal(4, 8), _normal(8, 4, seed=1))
        assert findings == []

    def test_half_accum_outside_contract_scope_is_only_a_warning(self):
        def dense(x, w):
            return x.to(torch.bfloat16) @ w.to(torch.bfloat16)

        hits = [f for f in _lint(dense, _normal(4, 8), _normal(8, 4, seed=1))
                if f.check == "half-accum"]
        assert len(hits) == 1 and hits[0].severity == WARNING and hits[0].site is None

    def test_half_reduce_in_contract_scope_is_an_error(self):
        def bad(x):
            with site_scope(SITE):
                return x.to(torch.float16).sum(0)

        hits = [f for f in _lint(bad, _normal(4, 8)) if f.check == "half-accum-reduce"]
        assert [(f.severity, f.site) for f in hits] == [(ERROR, SITE)]

    def test_unstabilized_fp16_exp_flagged_and_tanh_clears_it(self):
        def risky(x):
            return torch.exp(x.to(torch.float16))

        def stabilized(x):
            return torch.exp(torch.tanh(x.to(torch.float16)))

        def power(x):
            return x.to(torch.float16) ** 3

        flagged = _lint(risky, _normal(8))
        assert any(f.check == "fp16-overflow-risk" and f.severity == WARNING for f in flagged)
        assert [f for f in _lint(stabilized, _normal(8))
                if f.check == "fp16-overflow-risk"] == []
        assert any(f.check == "fp16-overflow-risk" for f in _lint(power, _normal(8)))

    def test_bf16_exp_is_not_an_overflow_risk(self):
        # bf16 keeps the f32 exponent range
        assert _lint(lambda x: torch.exp(x.to(torch.bfloat16)), _normal(8)) == []

    def test_round_trip_cast_detected(self):
        def wasteful(x):
            return x.to(torch.float16).float() + 1.0

        hits = [f for f in _lint(wasteful, _normal(8)) if f.check == "round-trip-cast"]
        assert len(hits) == 1 and hits[0].severity == WARNING

    def test_fp32_resident_demoted_site_is_an_error(self):
        policy = get_policy("mixed_fno_fp16")
        site = "fno/layer0/spectral/contract"
        assert policy.at(site).spectral_dtype is not None  # test premise

        def all_f32(x, w):
            with site_scope(site):
                return x @ w

        findings = trace_findings(all_f32, (_normal(4, 8), _normal(8, 4, seed=1)), policy,
                                  "seeded")
        hits = [f for f in findings if f.check == "fp32-resident"]
        assert len(hits) == 1
        assert hits[0].severity == ERROR and hits[0].site == site

    def test_half_accumulating_einsum_half_is_an_error(self, monkeypatch):
        """``core.contraction._einsum_half`` multiplies widened halves; one
        that multiplies at half fires in the contract scope."""
        sp = get_policy("mixed_fno_bf16").at(SITE)
        a = contraction.ComplexPair.from_complex(
            torch.complex(_normal(3, 4), _normal(3, 4, seed=1)), torch.bfloat16)
        b = _normal(4, 5, seed=2)

        def run(a, b):
            return sp.contract("bi,io->bo", a, b)

        assert [f for f in trace_findings(run, (a, b), get_policy("mixed_fno_bf16"), "seeded")
                if f.severity == ERROR] == []
        monkeypatch.setattr(contraction, "_einsum_half",
                            lambda expr, x, y, half: torch.einsum(expr, x.to(half), y.to(half)))
        hits = [f for f in trace_findings(run, (a, b), get_policy("mixed_fno_bf16"), "seeded")
                if f.check == "half-accum-contract"]
        assert len(hits) == 2 and all(f.site == SITE for f in hits)


class TestWidenThenMultiply:
    """ATen has no ``preferred_element_type``: f32 accumulation of half
    operands is written as widen, then multiply in f32."""

    def _trace(self, fn, *args):
        with recording() as rec:
            fn(*args)
        return df.trace_entries(rec.records), rec.records

    def test_widened_operands_read_as_their_half_dtype(self):
        def fn(x, w):
            with site_scope(SITE):
                xw = x.to(torch.bfloat16).float().t().reshape(8, 4)
                return xw.t() @ w.to(torch.bfloat16).float()

        entries, _ = self._trace(fn, _normal(4, 8), _normal(8, 4, seed=1))
        dots = [e for e in entries if e.startswith("dot_general")]
        assert dots == [f"dot_general[mm]:bfloat16,bfloat16->float32@acc=float32@{SITE}"]

    def test_genuine_f32_operand_reads_as_f32(self):
        def fn(x, w):
            return x.to(torch.bfloat16).float() @ w

        entries, _ = self._trace(fn, _normal(4, 8), _normal(8, 4, seed=1))
        assert [e for e in entries if e.startswith("dot_general")] == [
            "dot_general[mm]:bfloat16,float32->float32@acc=float32"]

    def test_compute_between_widen_and_multiply_breaks_the_reading(self):
        def fn(x, w):
            return (x.to(torch.bfloat16).float() * 2.0) @ w.to(torch.bfloat16).float()

        entries, _ = self._trace(fn, _normal(4, 8), _normal(8, 4, seed=1))
        assert [e for e in entries if e.startswith("dot_general")] == [
            "dot_general[mm]:float32,bfloat16->float32@acc=float32"]
        # and the multiply by 2 is compute: the pair is a round trip
        hits = [f for f in _lint(fn, _normal(4, 8), _normal(8, 4, seed=1))
                if f.check == "round-trip-cast"]
        assert len(hits) == 1

    def test_pair_feeding_only_contractions_is_not_a_round_trip(self):
        def fn(x, w):
            xh = x.to(torch.float16).float()
            return xh @ w, xh.t() @ w.t()

        assert _lint(fn, _normal(4, 4), _normal(4, 4, seed=1)) == []

    def test_pair_feeding_a_contraction_and_an_add_is_a_round_trip(self):
        def fn(x, w):
            xh = x.to(torch.float16).float()
            return xh @ w, xh + 1.0

        hits = [f.check for f in _lint(fn, _normal(4, 4), _normal(4, 4, seed=1))]
        assert hits == ["round-trip-cast"]

    def test_half_output_is_half_accumulation_whatever_the_operands(self):
        def fn(x, w):
            with site_scope(SITE):
                return torch.mm(x.to(torch.float16).float(), w).to(torch.float16) @ \
                    w.to(torch.float16)

        hits = [f for f in _lint(fn, _normal(4, 4), _normal(4, 4, seed=1))
                if f.check == "half-accum-contract"]
        assert len(hits) == 1


class TestKernelRecords:
    @staticmethod
    def _io(cast_to, dtype=torch.float32):
        return LaunchIO((_normal(2, 4, 8).to(dtype),), (torch.empty(2, 4, 8, dtype=dtype),),
                        cast_to)

    @pytest.mark.parametrize("cast_to,resident", [(torch.float16, False), (None, True)])
    def test_kernel_record_counts_toward_fp32_resident(self, cast_to, resident):
        policy = get_policy("mixed_fno_fp16")
        site = "fno/layer0/spectral/contract"
        io = self._io(cast_to)
        with recording() as rec:
            with site_scope(site):
                rec.launch("spectral_fused_fwd", io)
        findings = df.analyze_records(rec.records, policy, "seeded")
        assert [f.check for f in findings] == (["fp32-resident"] if resident else [])
        (r,) = rec.records
        assert (r.kernel, r.site, r.cast_to) == (True, site, cast_to)

    def test_kernel_output_feeds_the_flow(self):
        io = self._io(None, torch.bfloat16)
        with recording() as rec:
            with site_scope(SITE):
                rec.launch("spectral_fused_fwd", io)
            io.outputs[0].float() + 1.0
        entries = df.trace_entries(rec.records)
        assert entries[0] == (f"kernel[spectral_fused_fwd]:bfloat16->bfloat16"
                              f"@acc=float32@{SITE}")
        # the kernel wrote the half tensor: its widening is no round trip
        assert df.analyze_records(rec.records, get_policy("full"), "seeded") == []

    def test_launch_without_its_io_is_refused(self):
        with recording() as rec, pytest.raises(RuntimeError, match="LaunchIO"):
            rec.launch("spectral_contract_dense_fwd", None)

    def test_recorders_do_not_nest(self):
        with recording(), pytest.raises(RuntimeError, match="already active"):
            with recording():
                pass


class TestSiteAttribution:
    def test_backward_ops_land_on_their_forward_site(self):
        x = _normal(4, 8).requires_grad_()
        w = _normal(8, 4, seed=1).requires_grad_()
        with recording() as rec:
            with site_scope(SITE):
                y = x @ w
            loss = torch.tanh(y).sum()
            torch.autograd.grad(loss, [x, w])
        back = [(r.op, r.site) for r in rec.records if r.backward]
        assert ("mm", SITE) in back
        assert ("tanh_backward", None) in back
        assert all(site == SITE for op, site in back if op == "mm")

    def test_backward_of_nested_scopes_lands_on_the_innermost(self):
        x = _normal(4, 8).requires_grad_()
        w = _normal(8, 4, seed=1).requires_grad_()
        outer = "sfno/layer0/spectral/fft_in"  # sorts after SITE
        with recording() as rec:
            with site_scope(outer):
                with site_scope(SITE):
                    y = x @ w
                z = torch.tanh(y)
            torch.autograd.grad(z.sum(), [x, w])
        back = {(r.op, r.site) for r in rec.records if r.backward}
        assert ("mm", SITE) in back and ("tanh_backward", outer) in back
        assert ("mm", outer) not in back

    def test_trainer_step_backward_is_attributed(self):
        from repro_torch.models import FNOConfig, init_fno
        from repro_torch.train import relative_l2

        cfg = FNOConfig(in_channels=1, out_channels=1, hidden_channels=8, lifting_channels=8,
                        projection_channels=8, n_layers=1, modes=(4, 4), fuse_spectral=False)
        net = init_fno(torch.Generator().manual_seed(0), cfg, device="cpu")
        policy = get_policy("mixed_fno_bf16")
        with recording() as rec:
            loss = relative_l2(net(_normal(2, 1, 16, 16), policy), _normal(2, 1, 16, 16, seed=1))
            torch.autograd.grad(loss, list(net.parameters()))
        sites = {r.site for r in rec.records if r.backward}
        assert {"fno/layer0/spectral/contract", "fno/layer0/spectral/fft_in"} <= sites
        # the dense contraction's backward: its plain versions' contractions
        dots = [r for r in rec.records if r.backward and r.op == "bmm"]
        assert dots and all(r.site == "fno/layer0/spectral/contract" for r in dots)

    def test_scopes_nest_and_unwind(self):
        from repro_torch.precision import current_site

        assert current_site() is None
        with site_scope("a/spectral/fft_in"):
            with site_scope(SITE):
                assert current_site() == SITE
            assert current_site() == "a/spectral/fft_in"
        assert current_site() is None


# ---------------------------------------------------------------------------
# Rule tables and site literals
# ---------------------------------------------------------------------------


class TestSeededRuleTableViolations:
    def test_shadowed_rule_detected(self):
        rules = (("*", SiteRule(compute="float32")), ("fno/*", SiteRule(compute="bfloat16")))
        assert shadowed_entries(rules, site_universe()) == [(1, "fno/*", ("compute",))]
        hits = [f for f in rule_table_findings(tables={"seeded": rules})
                if f.check == "shadowed-rule"]
        assert [(f.severity, f.site, f.where) for f in hits] == [(ERROR, "fno/*", "seeded[1]")]

    def test_specific_before_catchall_is_not_shadowed(self):
        rules = (("fno/*", SiteRule(compute="bfloat16")), ("*", SiteRule(compute="float32")))
        assert shadowed_entries(rules, site_universe()) == []

    def test_distinct_field_is_not_shadowed(self):
        rules = (("*", SiteRule(compute="float32")), ("fno/*", SiteRule(accum="float32")))
        assert shadowed_entries(rules, site_universe()) == []

    def test_pattern_matching_nothing_is_an_error(self):
        rules = (("nonexistent/bogus/site", SiteRule(compute="float32")),)
        hits = [f for f in rule_table_findings(tables={"seeded": rules})
                if f.check == "pattern-no-match"]
        assert len(hits) == 1 and hits[0].severity == ERROR


class TestSeededSiteLiteralViolations:
    def test_orphan_site_literal_detected(self, tmp_path):
        (tmp_path / "mod.py").write_text(textwrap.dedent("""
            def f(policy, x):
                good = policy.at("fno/layer0/spectral/contract")
                bad = policy.at("fno/layer0/spectral/contracct")  # typo
                return good, bad
        """))
        (f,) = tsites.orphan_site_findings(str(tmp_path))
        assert (f.check, f.severity, f.site, f.where) == (
            "orphan-site", ERROR, "fno/layer0/spectral/contracct", "mod.py:4")

    def test_site_scope_literal_is_checked(self, tmp_path):
        (tmp_path / "mod.py").write_text(textwrap.dedent("""
            def f(i):
                with site_scope(f"fno/layer{i}/spectral/fft_out"):
                    pass
                with site_scope("fno/layer0/spectrl/fft_out"):
                    pass
        """))
        findings = tsites.orphan_site_findings(str(tmp_path))
        assert [(f.site, f.where) for f in findings] == [
            ("fno/layer0/spectrl/fft_out", "mod.py:5")]

    def test_fstring_prefix_literals_recognised(self, tmp_path):
        (tmp_path / "mod.py").write_text(textwrap.dedent("""
            def f(policy, i):
                return policy.at(f"sfno/layer{i}/spectral/fft_in")
        """))
        assert tsites.orphan_site_findings(str(tmp_path)) == []

    def test_syntax_error_fails_loudly(self, tmp_path):
        (tmp_path / "broken.py").write_text("def f(:\n")
        with pytest.raises(SyntaxError):
            tsites.orphan_site_findings(str(tmp_path))


def _jrules(rules):
    """The same table with the reference's SiteRule."""
    return tuple((p, JSiteRule(**{f: getattr(r, f) for f in ("compute", "accum", "stabilize",
                                                             "quantize", "loss_scaling")
                                  if getattr(r, f) is not tsites.UNSET}))
                 for p, r in rules)


class TestParityWithReference:
    SEEDED = {
        "shadowed": (("*", SiteRule(compute="float32")), ("fno/*", SiteRule(compute="bf16"))),
        "ordered": (("fno/*", SiteRule(compute="bf16")), ("*", SiteRule(compute="float32"))),
        "distinct": (("*", SiteRule(compute="float32")), ("fno/*", SiteRule(accum="f32"))),
        "dead": (("nonexistent/bogus/site", SiteRule(compute="float32")),
                 ("sfno/layer3/spectral/*", SiteRule(quantize="half"))),
    }

    @staticmethod
    def _key(findings):
        return {(f.check, f.site, f.where) for f in findings}

    def test_rule_table_findings_equal_the_reference(self):
        assert self._key(rule_table_findings()) == self._key(jsites.rule_table_findings())
        for name, rules in self.SEEDED.items():
            port = rule_table_findings(tables={name: rules})
            ref = jsites.rule_table_findings(tables={name: _jrules(rules)})
            assert self._key(port) == self._key(ref), name

    def test_is_recognized_equals_the_reference(self):
        lits = {p for _, _, p in jsites.scan_site_literals(os.path.join(_SRC, "repro"))}
        lits |= {p for _, _, p in tsites.scan_site_literals(os.path.join(_SRC, "repro_torch"))}
        seeded = {"fno/layer0/spectral/contracct", "fno/layer*/spectral", "sfno/layer*/dense",
                  "bogus", "*/spectral/fft_out", "lm/ssd/spectral/contract", "gino/proj_out",
                  "unet/dense", "model/spectral", "serve/paged/pool", "x/spectral/contract",
                  "fno/layer*/spectrl"}
        verdicts = {p: tsites._is_recognized(p) for p in lits | seeded}
        assert verdicts == {p: jsites._is_recognized(p) for p in lits | seeded}
        assert not verdicts["fno/layer0/spectral/contracct"] and verdicts["fno/layer*/spectral"]

    def test_calibration_verdicts_equal_the_reference(self, tmp_path):
        entries = {
            "unknown": {"family": "bogus", "block_fwd": 1, "block_bwd": 1},
            "npow2": {"family": "spectral_fused", "shape": [8, 64, 64, 128, 128, 32, 32],
                      "dtype": "bfloat16", "block_fwd": 3, "block_bwd": 4},
            "zero": {"family": "lshared", "shape": [8, 64, 64, 128, 128],
                     "dtype": "bfloat16", "block_fwd": 4, "block_bwd": 0},
            "not_a_dict": [1, 2],
        }
        path = tmp_path / "state.json"
        path.write_text(json.dumps({"format_version": 1, "kernel_version": 1,
                                    "backend": "x", "entries": entries}))
        port = self._key(tkernels.calibration_pass(str(path)))
        assert port == self._key(jkernels.calibration_pass(str(path)))
        assert {w for _, _, w in port} == {f"calibration:{k}" for k in entries}
        for bad in ("missing.json", "garbage.json"):
            if bad == "garbage.json":
                (tmp_path / bad).write_text("{not json")
            p = str(tmp_path / bad)
            assert [f.check for f in tkernels.calibration_pass(p)] == \
                [f.check for f in jkernels.calibration_pass(p)] == ["calibration-coverage"]


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------


def _fused_trace(launches, shape=(3, 4, 4, (8, 8), (3, 3)), family="spectral_fused/bwd"):
    return tkernels.FamilyTrace(family, shape, "float32", launches)


def _fused_launch(b0, n, B=3, accumulate=None, name="spectral_fused_bwd"):
    y = torch.empty(B, 4, 8, 8)
    ints = (n, 4, 4, 2, 8, 8, 1, 3, 3, 1, 0, 0) + ((accumulate,) if accumulate is not None else ())
    return tkernels.KernelLaunch(name, ints, LaunchIO((), (y[b0:b0 + n],)))


class TestLaunchPlans:
    def test_recorder_plans_on_the_cpu_and_launches_nothing(self):
        x = torch.empty(3, 4, 8, 8)
        wg = [torch.empty(4, 4, 18) for _ in range(2)]
        loaders = {n: getattr(sc, n) for n in tkernels._LOADERS}
        call = sc._call
        with tkernels.record_launches("cpu") as launches:
            y = sc._launch_fused_fwd(x, *wg, (3, 3), torch.bfloat16, None)
        assert [(la.name, la.ints) for la in launches] == [
            ("spectral_fused_fwd", (2, 4, 4, 2, 8, 8, 1, 3, 3, 1, 1, 0)),
            ("spectral_fused_fwd", (1, 4, 4, 2, 8, 8, 1, 3, 3, 1, 1, 0))]
        assert y.shape == (3, 4, 8, 8)
        assert sc._call is call
        assert {n: getattr(sc, n) for n in tkernels._LOADERS} == loaders

    def test_cp_and_lshared_plans_need_no_card(self):
        ops = [torch.empty(s, dtype=torch.bfloat16) for s in
               [(2, 8, 40)] * 2 + [(8, 4)] * 4 + [(4, 40)] * 2]
        with tkernels.record_launches("cpu") as launches:
            sc._launch_cp_bwd(*ops, *[torch.empty(2, 8, 40, dtype=torch.bfloat16)] * 2)
            x = [torch.empty(2, 8, 12, 9, dtype=torch.float16)] * 2
            sc._launch_ls_fwd(*x, *[torch.empty(8, 8, 12, dtype=torch.float16)] * 2)
        assert [la.name for la in launches] == ["spectral_contract_cp_bwd",
                                                "spectral_contract_ls_fwd"]
        # ls_fwd: B, I, O, L, M, resident, splits (at an H100's SM count), fmt
        assert launches[1].ints[:5] == (2, 8, 8, 12, 9)
        assert launches[1].ints[6:] == (2, 2)

    def test_kernels_pass_clean_and_covers_every_family(self):
        traces = tkernels.trace_families("cpu")
        assert {tr.family for tr in traces} == {
            f"{f}/{d}" for f in ("dense", "dense-fused", "cp", "lshared", "spectral_fused")
            for d in ("fwd", "bwd")}
        assert all(tr.launches for tr in traces)
        assert kernels_pass("cpu", traces) == []

    def test_ragged_batch_tiles_cover_each_row_once(self):
        good = [_fused_launch(0, 2, accumulate=0), _fused_launch(2, 1, accumulate=1)]
        assert tkernels.check_trace(_fused_trace(good)) == []

    @pytest.mark.parametrize("launches,checks", [
        ([_fused_launch(0, 2, accumulate=0), _fused_launch(2, 2, B=4, accumulate=1)],
         ["index-oob", "output-not-covered"]),
        ([_fused_launch(0, 2, accumulate=0), _fused_launch(2, 1, B=4, accumulate=1),
          _fused_launch(0, 9, B=9, accumulate=1)], ["index-oob"]),
        ([_fused_launch(0, 2, accumulate=0)], ["output-not-covered"]),
        ([_fused_launch(0, 2, accumulate=0), _fused_launch(1, 2, accumulate=1)],
         ["output-not-covered"]),
        ([_fused_launch(0, 2, accumulate=0), _fused_launch(2, 1, accumulate=0)],
         ["accum-discipline"]),
        ([_fused_launch(0, 2, accumulate=1), _fused_launch(2, 1, accumulate=1)],
         ["accum-discipline"]),
    ])
    def test_seeded_fused_tile_faults(self, launches, checks):
        findings = tkernels.check_trace(_fused_trace(launches))
        assert [f.check for f in findings] == checks
        assert all(f.severity == ERROR for f in findings)

    def test_ls_splits_beyond_the_outputs_are_oob(self):
        la = tkernels.KernelLaunch("spectral_contract_ls_fwd", (2, 8, 8, 12, 9, 1, 3, 1), None)
        tr = tkernels.FamilyTrace("lshared/fwd", (2, 8, 8, 12, 9), "bfloat16", [la])
        assert [f.check for f in tkernels.check_trace(tr)] == ["index-oob"]

    def test_plan_over_the_shared_memory_limit(self, monkeypatch):
        la = tkernels.KernelLaunch("spectral_contract_cp_fwd", (2, 8, 8, 4, 40, 1, 1), None)
        tr = tkernels.FamilyTrace("cp/fwd", (2, 8, 8, 4, 40), "bfloat16", [la])
        assert tkernels.check_trace(tr) == []
        monkeypatch.setattr(sc, "SMEM_LIMIT", tkernels.plan_bytes(la) - 1)
        assert [f.check for f in tkernels.check_trace(tr)] == ["smem-over-limit"]

    def test_fused_scratch_over_half_the_l2(self, monkeypatch):
        tr = _fused_trace([_fused_launch(0, 2, accumulate=0), _fused_launch(2, 1, accumulate=1)])
        monkeypatch.setattr(sc, "L2_BUDGET", 2 * sc.fused_scratch_bytes(2, 4, 4, (8, 8), (3, 3))
                            - 2)
        assert [f.check for f in tkernels.check_trace(tr)] == ["l2-over-budget"]

    def test_family_with_no_launch(self):
        tr = tkernels.FamilyTrace("dense/fwd", (2, 8, 8, 40), "float32", [])
        assert [f.check for f in kernels_pass("cpu", [tr])] == ["no-kernel-traced"]

    def test_calibration_entries_the_rules_refuse(self, tmp_path):
        fused = [8, 64, 64, 421, 421, 32, 32]
        entries = {
            "ok": {"family": "spectral_fused", "shape": fused, "dtype": "bfloat16",
                   "block_fwd": 8, "block_bwd": 8},
            "too_many_rows": {"family": "spectral_fused", "shape": [32] + fused[1:],
                              "dtype": "bfloat16", "block_fwd": 16, "block_bwd": 8},
            "splits": {"family": "lshared", "shape": [1, 64, 64, 128, 128],
                       "dtype": "bfloat16", "block_fwd": 2, "block_bwd": 4},
            "no_tile": {"family": "cp", "shape": [8, 64, 64, 64, 1764], "dtype": "bfloat16",
                        "block_fwd": 8, "block_bwd": 8},
        }
        path = tmp_path / "state.json"
        path.write_text(json.dumps({"format_version": 1, "kernel_version": 1,
                                    "backend": "x", "entries": entries}))
        got = sorted((f.where, f.detail.split(":")[0]) for f in
                     tkernels.calibration_pass(str(path)))
        assert [w for w, _ in got] == ["calibration:no_tile", "calibration:splits",
                                       "calibration:splits", "calibration:too_many_rows"]
        assert tkernels.calibration_pass(None) == []


# ---------------------------------------------------------------------------
# Clean tree: the shipped port gives no unsuppressed error
# ---------------------------------------------------------------------------


_SUPPRESSIONS = load_suppressions(DEFAULT_SUPPRESSIONS)


class TestCleanTree:
    def test_sites_pass_clean_on_the_port(self):
        assert [f for f in sites_pass(os.path.join(_SRC, "repro_torch"))
                if f.severity == ERROR] == []

    @pytest.mark.parametrize("policy_name", sorted(POLICIES))
    def test_models_and_trainer_have_no_errors(self, policy_name):
        policy = get_policy(policy_name)
        findings = []
        for model in ("fno", "tfno", "sfno"):
            findings += model_findings(model, policy)
        findings += model_findings("fno", policy, fuse_spectral=True)
        findings += trainer_findings(policy) + trainer_findings(policy, fuse_spectral=True)
        active, _ = partition(findings, _SUPPRESSIONS)
        assert [f for f in active if f.severity == ERROR] == []
        # every demoted contract site was seen at its half dtype
        assert not any(f.check == "fp32-resident" for f in findings)

    def test_obs_coverage_is_all_reviewed(self):
        from repro_torch.analyze import obs_coverage_pass

        findings = obs_coverage_pass(_SRC)
        active, suppressed = partition(findings, _SUPPRESSIONS)
        assert active == [] and suppressed


# ---------------------------------------------------------------------------
# Golden dtype traces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDEN) as fh:
        return json.load(fh)


class TestGoldenParity:
    @pytest.mark.parametrize("name", sorted(POLICIES))
    def test_projection_equals_the_golden(self, goldens, name):
        policy = get_policy(name)
        staged = project(dtype_trace(policy))
        assert staged == project(goldens[name]) == project(goldens[name + "+pallas"])
        assert project(dtype_trace(policy, fuse_spectral=True)) == \
            project(goldens[name + "+fused"])

    def test_projection_fails_for_a_half_accumulating_contraction(self, goldens, monkeypatch):
        """The staged dense layer contracts through the dense kernel's plain
        version on the CPU (``_einsum_half`` is the Tucker/einsum path's; its
        own seeded fault is in ``TestSeededDataflowViolations``)."""
        monkeypatch.setattr(sc, "spectral_contract_plain", _half_plain)
        trace = dtype_trace(get_policy("mixed_fno_bf16"))
        assert project(trace) != project(goldens["mixed_fno_bf16"])
        assert project(trace)["model/spectral/contract"]["contract"] == [
            ("bfloat16", "bfloat16")]

    def test_projection_fails_for_a_skipped_quantize(self, goldens, monkeypatch):
        monkeypatch.setattr(SitePrecision, "quantize", lambda _self, c: c)
        for name in ("mixed_fno_bf16", "half_fno_only"):
            trace = dtype_trace(get_policy(name))
            assert project(trace) != project(goldens[name])
            assert project(trace)["model/spectral/fft_in"]["half"] == []

    def test_full_policy_is_all_f32(self):
        for fused in (False, True):
            for entry in dtype_trace(get_policy("full"), fuse_spectral=fused):
                assert "float16" not in entry and "bfloat16" not in entry, entry


# ---------------------------------------------------------------------------
# Scope wiring changes no value
# ---------------------------------------------------------------------------


class _NoScope:
    def __init__(self, site):
        del site

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _no_scopes(monkeypatch):
    import repro_torch.core.spectral as spectral
    import repro_torch.kernels.ops as kops
    import repro_torch.models.sfno as sfno
    import repro_torch.precision.policy as policy

    for mod in (spectral, kops, sfno, policy):
        monkeypatch.setattr(mod, "site_scope", _NoScope)


@pytest.mark.parametrize("model", ["fno", "tfno", "sfno"])
def test_scopes_and_recorder_change_no_value(model, monkeypatch):
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.train import Trainer, TrainerConfig, relative_l2

    policy = get_policy("mixed_fno_bf16")

    def run():
        _cfg, net, x = df.tiny_model(model, "cpu")
        y = net(x, policy)
        t = _normal(*y.shape, seed=5)
        grads = torch.autograd.grad(relative_l2(y, t), list(net.parameters()))
        tr = Trainer(lambda m, b, p: relative_l2(m(b["x"], p), b["t"]), net,
                     TrainerConfig(total_steps=1,
                                   schedule=PrecisionSchedule.constant(policy.name)),
                     device="cpu")
        hist = tr.run(lambda _s: {"x": x, "t": t}, steps=1)
        return [y.detach(), *grads, torch.tensor(hist[0]["loss"]),
                *[p.detach() for p in tr.params.values()]]

    plain = run()
    with recording():
        recorded = run()
    with monkeypatch.context() as m:
        _no_scopes(m)
        unscoped = run()
    for a, b, c in zip(plain, recorded, unscoped, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


# ---------------------------------------------------------------------------
# Suppressions and the CLI
# ---------------------------------------------------------------------------


def _finding(check="half-accum", severity=WARNING, site="fno/dense", where="fno/full"):
    return Finding(pass_name="dataflow", check=check, severity=severity, site=site,
                   where=where, detail="d")


class TestSuppressions:
    def test_partition_by_check_and_site_pattern(self):
        sup = Suppression(check="half-accum", reason="reviewed", site="fno/*")
        active, suppressed = partition(
            [_finding(), _finding(site="sfno/dense"), _finding(check="round-trip-cast")], [sup])
        assert len(suppressed) == 1 and suppressed[0].site == "fno/dense"
        assert len(active) == 2

    def test_site_pattern_never_matches_siteless_finding(self):
        sup = Suppression(check="half-accum", reason="r", site="*")
        active, suppressed = partition([_finding(site=None)], [sup])
        assert suppressed == [] and len(active) == 1

    def test_load_suppressions_roundtrip(self, tmp_path):
        p = tmp_path / "allowlist.toml"
        p.write_text(textwrap.dedent("""
            # comment
            [[suppress]]
            check = "round-trip-cast"
            site = "*/spectral/fft_in"
            reason = "Thm 3.2 boundary quantiser"
        """))
        assert load_suppressions(str(p)) == (Suppression(
            check="round-trip-cast", reason="Thm 3.2 boundary quantiser",
            site="*/spectral/fft_in"),)

    def test_missing_file_is_empty_allowlist(self, tmp_path):
        assert load_suppressions(str(tmp_path / "nope.toml")) == ()

    def test_entry_without_reason_rejected(self, tmp_path):
        p = tmp_path / "allowlist.toml"
        p.write_text('[[suppress]]\ncheck = "half-accum"\n')
        with pytest.raises(ValueError, match="reason"):
            load_suppressions(str(p))

    def test_unknown_key_rejected(self, tmp_path):
        p = tmp_path / "allowlist.toml"
        p.write_text('[[suppress]]\ncheck = "x"\nreason = "r"\nseverty = "oops"\n')
        with pytest.raises(ValueError, match="unknown"):
            load_suppressions(str(p))

    def test_shipped_allowlist_parses_and_names_the_port(self):
        assert _SUPPRESSIONS and all(s.reason for s in _SUPPRESSIONS)
        assert all(s.where is None or s.where.startswith("repro_torch/") for s in _SUPPRESSIONS)

    def test_dedupe_keeps_first_seen_order(self):
        a, b = _finding(), _finding(check="other")
        assert dedupe([a, b, a]) == [a, b]


class TestCLI:
    def test_main_writes_report_and_exits_zero(self, tmp_path, capsys):
        out = tmp_path / "analyze.json"
        rc = analyze_main(["--device", "cpu", "--policies", "mixed_fno_bf16", "--models", "fno",
                           "sfno", "--paths", "both", "--skip", "kernels", "--out", str(out)])
        assert rc == 0
        report = json.loads(out.read_text())
        assert report["policies"] == ["mixed_fno_bf16"] and report["device"] == "cpu"
        assert report["paths"] == ["staged", "fused"]
        assert report["summary"]["errors"] == 0 and report["suppressed"]
        assert "wrote" in capsys.readouterr().out

    def test_main_exits_one_on_an_unsuppressed_error(self, tmp_path, monkeypatch):
        monkeypatch.setattr(sc, "spectral_contract_plain", _half_plain)
        rc = analyze_main(["--device", "cpu", "--policies", "mixed_fno_bf16", "--models", "fno",
                           "--paths", "staged", "--no-trainer", "--skip", "kernels", "sites",
                           "obs", "--out", str(tmp_path / "a.json")])
        assert rc == 1

    def test_no_card_and_no_device_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            analyze_main(["--out", str(tmp_path / "a.json")])


def _half_plain(xr, xi, wr, wi, *, cast_to=None, out_dtype=torch.float32):
    """The dense plain version multiplying at the storage dtype: a
    half-accumulating contraction."""
    dt = cast_to or xr.dtype

    def bmm(a, b):
        return torch.einsum("bim,iom->bom", a.to(dt), b.to(dt))

    return (bmm(xr, wr) - bmm(xi, wi)).to(out_dtype), (bmm(xr, wi) + bmm(xi, wr)).to(out_dtype)

