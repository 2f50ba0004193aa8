"""Memory-greedy tensor-contraction engine (paper Section 4.2, Appendix B.12).

The paper decomposes every multi-operand spectral einsum into two-operand
sub-contractions, picks the next pair greedily by the size of the
intermediate tensor (opt-einsum's default minimises FLOPs instead; Table
10 shows the memory-greedy path saves up to 12 % memory on 3-D problems),
and caches the path, since shapes are static (Table 9).

* ``greedy_path(expr, shapes, objective)``: the pairwise path,
  ``objective`` in {"memory", "flops"}.
* ``PathCache``: shape-keyed memoisation of paths.
* ``contract(expr, *ops, policy=...)``: runs the path on real tensors,
  complex64 tensors or split-real ``ComplexPair``s.  Under a half rule
  each pairwise complex product runs as real einsums whose products and
  sums are f32 and whose result is rounded to the site's storage dtype.

Tucker weights take this path (as in the reference, which has no Tucker
kernel); the pairwise products are plain ``torch.einsum`` calls, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.precision import FULL

Path = Tuple[Tuple[int, int], ...]
Parsed = Tuple[List[str], str, Dict[str, int]]


class ComplexPair(NamedTuple):
    """A complex tensor stored as two real tensors of one dtype."""

    re: torch.Tensor
    im: torch.Tensor

    @classmethod
    def from_complex(cls, c: torch.Tensor, dtype: torch.dtype) -> "ComplexPair":
        return cls(c.real.to(dtype), c.imag.to(dtype))

    def to_complex(self) -> torch.Tensor:
        return torch.complex(self.re.float(), self.im.float())

    @property
    def shape(self):
        return self.re.shape


# -- expression parsing ---------------------------------------------------------
def _parse(expr: str, shapes: Sequence[Tuple[int, ...]]) -> Parsed:
    expr = expr.replace(" ", "")
    if "->" in expr:
        lhs, out = expr.split("->")
    else:
        lhs = expr
        # implicit output: indices appearing exactly once, sorted
        counts: Dict[str, int] = {}
        for term in lhs.split(","):
            for ch in term:
                counts[ch] = counts.get(ch, 0) + 1
        out = "".join(sorted(ch for ch, n in counts.items() if n == 1))
    terms = lhs.split(",")
    if len(terms) != len(shapes):
        raise ValueError(f"{expr}: {len(terms)} terms but {len(shapes)} operands")
    dims: Dict[str, int] = {}
    for term, shape in zip(terms, shapes, strict=True):
        if len(term) != len(shape):
            raise ValueError(f"term {term} rank mismatch with shape {tuple(shape)}")
        for ch, s in zip(term, shape, strict=True):
            if ch in dims and dims[ch] != s:
                raise ValueError(f"index {ch}: size {dims[ch]} vs {s}")
            dims[ch] = s
    return terms, out, dims


def _pair_output(a: str, b: str, others: List[str], final: str) -> str:
    """Indices of the intermediate from contracting terms a, b: every index
    of a ∪ b still needed by a remaining operand or the final output."""
    needed = set(final)
    for t in others:
        needed |= set(t)
    return "".join(ch for ch in dict.fromkeys(a + b) if ch in needed)


def _size(term: str, dims: Dict[str, int]) -> int:
    n = 1
    for ch in term:
        n *= dims[ch]
    return n


def _pair_flops(a: str, b: str, dims: Dict[str, int]) -> int:
    # 2 * prod(all involved indices)
    return 2 * _size("".join(dict.fromkeys(a + b)), dims)


def _steps(expr: str, shapes: Sequence[Tuple[int, ...]], path: Path):
    """(a, b, out, dims) of each pairwise step of ``path``."""
    terms, final, dims = _parse(expr, shapes)
    for i, j in path:
        others = [t for k, t in enumerate(terms) if k not in (i, j)]
        out = _pair_output(terms[i], terms[j], others, final)
        yield terms[i], terms[j], out, dims
        terms = others + [out]


# -- greedy path search ----------------------------------------------------------
def greedy_path(
    expr: str,
    shapes: Sequence[Tuple[int, ...]],
    objective: str = "memory",
    parsed: Optional[Parsed] = None,
) -> Path:
    """Pairwise contraction order.

    ``objective="memory"``: at each step the pair whose intermediate is
    smallest (the paper's choice), FLOPs breaking ties; ``"flops"``: the
    pair with the fewest FLOPs, size breaking ties (the Table 10 baseline).
    """
    terms, final, dims = parsed if parsed is not None else _parse(expr, shapes)
    terms = list(terms)
    path: List[Tuple[int, int]] = []
    while len(terms) > 1:
        best = None
        for i in range(len(terms)):
            for j in range(i + 1, len(terms)):
                others = [t for k, t in enumerate(terms) if k not in (i, j)]
                out = _pair_output(terms[i], terms[j], others, final)
                mem, fl = _size(out, dims), _pair_flops(terms[i], terms[j], dims)
                key = (mem, fl) if objective == "memory" else (fl, mem)
                if best is None or key < best[0]:
                    best = (key, i, j, out)
        _, i, j, out = best
        path.append((i, j))
        terms = [t for k, t in enumerate(terms) if k not in (i, j)] + [out]
    return tuple(path)


class PathCache:
    """Shape-keyed path memoisation (Table 9: path search is up to 76 % of
    an einsum call if redone every time).  Thread-safe."""

    def __init__(self):
        self._cache: Dict[Any, Path] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, expr: str, shapes: Sequence[Tuple[int, ...]], objective: str,
            parsed: Optional[Parsed] = None) -> Path:
        key = (expr, tuple(map(tuple, shapes)), objective)
        with self._lock:
            p = self._cache.get(key)
            if p is not None:
                self.hits += 1
                return p
        p = greedy_path(expr, shapes, objective, parsed=parsed)
        with self._lock:
            self._cache[key] = p
            self.misses += 1
        return p

    def clear(self):
        with self._lock:
            self._cache.clear()
            self.hits = self.misses = 0


_GLOBAL_PATH_CACHE = PathCache()


def global_path_cache() -> PathCache:
    return _GLOBAL_PATH_CACHE


# -- pairwise execution with mixed precision ---------------------------------------
def _einsum_half(expr: str, a: torch.Tensor, b: torch.Tensor, half) -> torch.Tensor:
    """Products and sums in f32 of operands on the half grid (exact
    products), rounded once to ``half``: ``preferred_element_type=f32``."""
    return torch.einsum(expr, a.float(), b.float()).to(half)


def _pairwise(expr: str, a, b, policy):
    """One two-operand contraction, dispatching on operand kinds.

    ComplexPair × ComplexPair -> 4 real einsums, f32 sums, rounded to half.
    ComplexPair × real        -> 2 real einsums.
    complex64 × {complex64, real} -> one einsum (the full path).
    """
    pa, pb = isinstance(a, ComplexPair), isinstance(b, ComplexPair)
    if pa or pb:
        half = policy.spectral_dtype or torch.float32
        if pa and pb:
            def e(x, y):
                return torch.einsum(expr, x.float(), y.float())

            rr, ii, ri, ir = e(a.re, b.re), e(a.im, b.im), e(a.re, b.im), e(a.im, b.re)
            return ComplexPair((rr - ii).to(half), (ri + ir).to(half))
        if pa:
            breal = b.to(half)
            return ComplexPair(_einsum_half(expr, a.re, breal, half),
                               _einsum_half(expr, a.im, breal, half))
        areal = a.to(half)
        return ComplexPair(_einsum_half(expr, areal, b.re, half),
                           _einsum_half(expr, areal, b.im, half))
    if a.is_complex() or b.is_complex():
        a, b = a.to(torch.complex64), b.to(torch.complex64)
    else:
        a, b = a.to(policy.accum), b.to(policy.accum)
    return torch.einsum(expr, a, b)


def contract(
    expr: str,
    *operands,
    policy=FULL,
    objective: str = "memory",
    cache: Optional[PathCache] = None,
):
    """Run a multi-operand einsum along the memory-greedy path.

    ``policy``: a ``SitePrecision`` already resolved by the caller
    (``policy.at("fno/layer2/spectral/contract")``), or a PrecisionPolicy,
    resolved at its ``model/spectral/contract`` site.  Under a half rule
    complex operands become split-real ComplexPairs at the storage dtype
    and real float operands are rounded to it (weights and inputs both in
    half, Table 11).  Returns a ComplexPair under a half rule, else a
    tensor.
    """
    if not hasattr(policy, "spectral_is_half"):
        policy = policy.at("model/spectral/contract")
    cache = cache or _GLOBAL_PATH_CACHE
    ops = list(operands)
    if policy.spectral_is_half:
        half = policy.spectral_dtype
        ops = [ComplexPair.from_complex(o, half)
               if not isinstance(o, ComplexPair) and o.is_complex() else o for o in ops]
        ops = [o.to(half) if not isinstance(o, ComplexPair)
               and o.dtype in (torch.float32, torch.float64) else o for o in ops]

    shapes = [tuple(o.shape) for o in ops]
    parsed = _parse(expr, shapes)
    terms, final, _ = parsed
    path = cache.get(expr, shapes, objective, parsed=parsed)

    terms = list(terms)
    vals = list(ops)
    for i, j in path:
        others = [t for k, t in enumerate(terms) if k not in (i, j)]
        out = _pair_output(terms[i], terms[j], others, final)
        res = _pairwise(f"{terms[i]},{terms[j]}->{out}", vals[i], vals[j], policy)
        vals = [v for k, v in enumerate(vals) if k not in (i, j)] + [res]
        terms = others + [out]

    (result,) = vals
    (term,) = terms
    if term != final:
        # final transpose/trace fix-up
        perm = f"{term}->{final}"
        if isinstance(result, ComplexPair):
            return ComplexPair(torch.einsum(perm, result.re), torch.einsum(perm, result.im))
        return torch.einsum(perm, result)
    return result


def path_intermediate_bytes(expr: str, shapes: Sequence[Tuple[int, ...]], path: Path,
                            itemsize: int = 4) -> int:
    """Peak intermediate size along a path (the last step's output is the
    result, not an intermediate)."""
    sizes = [_size(out, dims) * itemsize for _, _, out, dims in _steps(expr, shapes, path)]
    return max(sizes[:-1], default=0)


def path_flops(expr: str, shapes: Sequence[Tuple[int, ...]], path: Path) -> int:
    return sum(_pair_flops(a, b, dims) for a, b, _, dims in _steps(expr, shapes, path))
