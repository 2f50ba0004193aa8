"""The identities ``cp_fwd``'s half-mode rank-expand relies on, on the CPU.

``cp_fwd`` runs out = u·U_oᵀ on the tensor cores, whose operands are bf16
or fp16, although u is f32 and the reference never rounds it.  It splits u
into three bf16 pieces, and an fp16 U_o into two, so that each product is
exact and the sum over pieces is the product itself (``bf16_pieces`` below
is the kernel's ``split3`` in plain PyTorch):

* three bf16 pieces of an f32 value sum back to it exactly, from 1e-30 to
  1e30 and at the TFNO path's own u;
* two bf16 pieces of every finite fp16 value sum back to it exactly;
* a product of two pieces is exact in f32, so the pieces' products sum to
  the product of the unsplit values;
* the plan covers every width the forward kernel took before (R up to 784,
  any I and O), in every operand dtype.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import spectral_contract as sc

#: (B, I, O, R, M) of every CP launch on the TFNO path
CP_PATH_SHAPE = (8, 64, 64, 64, 42 * 42)


def bf16_pieces(v: torch.Tensor, n: int = 3) -> tuple[torch.Tensor, ...]:
    """The ``n`` bf16 pieces ``cp_fwd`` splits an f32 value into before a
    tensor-core product (u in three, an fp16 U_o in two): each the bf16
    rounding (to nearest even) of what the earlier pieces leave.  Their sum
    is ``v`` exactly where ``n`` pieces hold its significand: 3 x (8 + 1)
    bits cover f32's 24 above bf16's underflow, 2 x 9 cover fp16's 11."""
    rest, pieces = v.float(), []
    for _ in range(n):
        piece = rest.to(torch.bfloat16)
        pieces.append(piece)
        rest = rest - piece.float()
    return tuple(pieces)


def _f64_sum(pieces):
    return sum(p.double() for p in pieces)


@pytest.mark.parametrize("decade", range(-30, 31, 5))
def test_three_bf16_pieces_sum_back_to_an_f32_value(decade):
    g = np.random.default_rng(decade + 100)
    v = g.uniform(1.0, 10.0, 4096) * 10.0 ** decade * g.choice([-1.0, 1.0], 4096)
    u = torch.from_numpy(v.astype(np.float32))
    pieces = bf16_pieces(u, 3)
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    assert torch.equal(_f64_sum(pieces), u.double())
    # two pieces are not enough: the split needs its third
    assert not torch.equal(_f64_sum(pieces[:2]), u.double())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_three_bf16_pieces_sum_back_to_the_paths_u(dtype):
    """u = (x·U_i)⊙W of the TFNO path's shape, from operands at each
    operand dtype, as the kernel's mode scale leaves it in f32."""
    B, I, O, R, M = CP_PATH_SHAPE
    g = np.random.default_rng(7)
    shapes = ((B, I, M), (I, R), (O, R), (R, M))
    scales = (1.0, I ** -0.5, R ** -0.5, 1.0)
    ops = [torch.from_numpy((s * g.standard_normal(sh)).astype(np.float32)).to(dtype)
           for sh, s in zip(shapes, scales, strict=True) for _ in range(2)]
    (_, _, ur, ui), _ = sc._cp_stages(*ops)
    for u in (ur, ui):
        assert u.dtype == torch.float32
        assert torch.equal(_f64_sum(bf16_pieces(u, 3)), u.double())


def test_two_bf16_pieces_sum_back_to_every_finite_fp16_value():
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    h = bits.view(torch.float16)
    h = h[torch.isfinite(h)]
    assert h.numel() == 63488
    pieces = bf16_pieces(h, 2)
    assert torch.equal(_f64_sum(pieces), h.double())


@pytest.mark.parametrize("u_dtype", [torch.bfloat16, torch.float16])
def test_products_of_the_pieces_are_exact(u_dtype):
    """Σ_s u_s·v_t over the pieces, each product rounded to f32 as the
    tensor cores' products are not, equals u·v in f64: every piece product
    is exact in f32.  v is U_o at ``u_dtype`` (fp16 split in two)."""
    g = np.random.default_rng(3)
    u = torch.from_numpy(g.standard_normal(8192).astype(np.float32))
    v = torch.from_numpy(g.standard_normal(8192).astype(np.float32)).to(u_dtype)
    vs = bf16_pieces(v, 2) if u_dtype == torch.float16 else (v.to(torch.bfloat16),)
    total = torch.zeros(8192, dtype=torch.float64)
    for us in bf16_pieces(u, 3):
        for vt in vs:
            prod32 = us.float() * vt.float()
            assert torch.equal(prod32.double(), us.double() * vt.double())
            total += prod32.double()
    assert torch.equal(total, u.double() * v.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cp_fwd_plan_covers_every_width_it_took_before(dtype):
    """The old kernel took any I and O with R <= 784; the new plan fits a
    block at all of them (and past them), resident only up to 64."""
    for I in (1, 17, 64, 65, 300, 3000):
        for O in (1, 24, 64, 65, 2000):
            for R in (1, 17, 64, 65, 200, 784):
                plan = sc.cp_fwd_plan(I, O, R, dtype)
                assert plan.smem <= sc.SMEM_LIMIT
                assert plan.resident == (max(I, O, R) <= 64)
