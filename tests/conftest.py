"""Test-session setup.

Two jobs:

* The container may lack ``hypothesis``; the property tests only use a
  narrow slice of it (``given`` / ``settings`` / three strategies), so
  when the real package is missing we install a deterministic sampling
  shim into ``sys.modules`` before the test modules import.  The real
  package always wins when installed (CI installs it).
* The tier-1 CI matrix sets ``REPRO_USE_PALLAS=1`` on one leg: every
  tri-state ``use_pallas`` default (model configs, trainer, serving)
  then resolves to the Pallas kernels in interpret mode, so the same
  suite locks down both spectral paths.  The env var is honoured by
  ``repro.kernels.ops.resolve_use_pallas``; here we only surface which
  path the session runs in the pytest header.
"""
import functools
import inspect
import os
import random
import sys
import types


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running differential/fuzz cases; deselect with "
        "-m 'not slow' for the fast local loop (CI runs the full suite)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


def pytest_report_header(config):
    try:
        from repro.kernels.ops import resolve_fuse_spectral, resolve_use_pallas

        on = resolve_use_pallas(None)
        fused = on and resolve_fuse_spectral(None)
    except Exception:  # pragma: no cover - src not importable yet
        on = bool(os.environ.get("REPRO_USE_PALLAS"))
        fused = on
    path = "pallas" if on else "einsum"
    kernels = ["einsum"]
    if on:
        kernels = ["dense", "dense-fused", "cp", "lshared"]
        if fused:
            kernels.append("spectral_fused")
    return (f"repro spectral path: {path} "
            f"(REPRO_USE_PALLAS={os.environ.get('REPRO_USE_PALLAS')!r}, "
            f"REPRO_FUSE_SPECTRAL={os.environ.get('REPRO_FUSE_SPECTRAL')!r}); "
            f"active kernel set: {', '.join(kernels)}")

try:  # pragma: no cover - prefer the real thing
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _DEFAULT_EXAMPLES = 10

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def draw(self, rng):
            return self._draw(rng)

    def _integers(min_value=0, max_value=1 << 30, **_):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def _sampled_from(seq):
        choices = list(seq)
        return _Strategy(lambda rng: rng.choice(choices))

    def _settings(max_examples=_DEFAULT_EXAMPLES, **_):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    def _given(*strategies, **kw_strategies):
        def deco(fn):
            n_examples = getattr(fn, "_shim_max_examples", _DEFAULT_EXAMPLES)

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                rng = random.Random(fn.__qualname__)  # deterministic
                for _ in range(n_examples):
                    drawn = [s.draw(rng) for s in strategies]
                    drawn_kw = {k: s.draw(rng) for k, s in kw_strategies.items()}
                    fn(*args, *drawn, **drawn_kw, **kwargs)

            # hide the strategy-filled params from pytest's fixture
            # resolution (functools.wraps exposes the original signature)
            params = list(inspect.signature(fn).parameters.values())
            keep = params[: len(params) - len(strategies)]
            keep = [p for p in keep if p.name not in kw_strategies]
            wrapper.__signature__ = inspect.Signature(keep)
            del wrapper.__wrapped__
            return wrapper
        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = _given
    mod.settings = _settings
    st = types.ModuleType("hypothesis.strategies")
    st.integers = _integers
    st.floats = _floats
    st.sampled_from = _sampled_from
    mod.strategies = st
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st
