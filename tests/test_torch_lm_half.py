"""The port's LM pool under the half policies against ``repro.models.lm``
on the CPU: ``amp_bf16``, ``mixed_fno_bf16`` and ``mixed_fno_fp16`` at
smollm, mamba2 and deepseek (MLA + MoE), block by block, on the
reference's own weights bridged with ``lm_params_from_jax``.

The reference's jitted layer scan skips half roundings (its jitted logits
sit 0.7-1.0 of its own policy-vs-full gap from its op-by-op ones), so the
yardstick is the reference run op by op (``jax.disable_jit``).  Every
block of the port, fed the reference's own input, lies within 1/4 of that
block's policy-vs-full gap of the reference's block output; the final
norm is bit-equal but for rare f32 sum-order flips.  Over the whole model
the f32 sum-order differences of the GEMMs, which flip a bf16 rounding now
and then, compound: 0-0.28 of the gap at smollm, < 0.03 at deepseek, 0 at
mamba2 (four seeds each).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm.common as jc
import repro.models.lm.model as jm
import repro.models.lm.ssd as jssd
from repro.core import get_policy as jget_policy
import repro_torch.models.lm.common as tc
import repro_torch.models.lm.model as tm
from repro_torch.precision import get_policy

from test_torch_lm_models import Arch, npf, rel, tt

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def archs():
    return {}


def _arch(archs, name):
    if name not in archs:
        archs[name] = Arch(name)
    return archs[name]


def _jblock(lp, h, pos, window, cfg, policy):
    """``repro.models.lm.model.lm_forward``'s layer body (its scan's
    ``block``), run op by op."""
    dtype = policy.at("lm/dense").compute_dtype
    router = policy.at("lm/router").compute_dtype
    hn = jc.rmsnorm(h, lp["ln1"], cfg.norm_eps)
    if cfg.mixer == "attn":
        mix = jm._attn_forward(lp["attn"], hn, pos, window, cfg, dtype)
    elif cfg.mixer == "ssd":
        mix = jssd.ssd_forward(lp["ssd"], hn, cfg, policy)
    else:
        mix = 0.5 * (jm._attn_forward(lp["attn"], hn, pos, window, cfg, dtype)
                     + jssd.ssd_forward(lp["ssd"], hn, cfg, policy))
    h = h + mix
    if "ffn" in lp:
        f, _ = jm._ffn_forward(lp["ffn"], jc.rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg, dtype,
                               router)
        h = h + f
    return h


@pytest.mark.parametrize("policy", ["amp_bf16", "mixed_fno_bf16", "mixed_fno_fp16"])
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m", "deepseek-v2-lite-16b"])
def test_half_policies_block_by_block(archs, arch, policy):
    a = _arch(archs, arch)
    jpol, tpol, full = jget_policy(policy), get_policy(policy), jget_policy("full")
    dtype = jpol.at("lm/dense").compute_dtype
    toks = np.random.RandomState(13).randint(0, a.tcfg.vocab, (2, 16)).astype(np.int32)
    S = toks.shape[1]
    tpos = torch.arange(S)
    tdtypes = tm._dtypes(tpol)
    with jax.disable_jit(), torch.no_grad():
        h = a.jp["embed"][jnp.asarray(toks)].astype(dtype)
        windows = np.asarray(jm.layer_windows(a.jcfg))
        for i, tp in enumerate(a.tp.layers):
            lp = jax.tree_util.tree_map(lambda v, i=i: v[i], a.jp["layers"])
            want = _jblock(lp, h, jnp.arange(S), int(windows[i]), a.jcfg, jpol)
            ref32 = _jblock(lp, h.astype(jnp.float32), jnp.arange(S), int(windows[i]), a.jcfg,
                            full)
            got, _ = tm._block(tp, tt(h), tpos, int(windows[i]), a.tcfg, tpol, *tdtypes[:2])
            assert got.dtype == tdtypes[0]
            gap = rel(npf(want), npf(ref32))
            assert rel(npf(got), npf(want)) <= 0.25 * gap, (i, rel(npf(got), npf(want)), gap)
            h = want
        # the head, from the reference's last hidden state
        want = jc.rmsnorm(h, a.jp["final_norm"], a.jcfg.norm_eps)
        got = tc.rmsnorm(tt(h), a.tp.final_norm, a.tcfg.norm_eps)
        assert np.mean(npf(got) != npf(want)) <= 0.01


