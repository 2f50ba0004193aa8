"""Plain oracles for the kernels (the correctness contract)."""
from __future__ import annotations

import torch


def spectral_contract_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle for the spectral contraction.

    x: (B, I, M) complex64; w: (I, O, M) complex64 -> (B, O, M) complex64.
    """
    return torch.einsum("bim,iom->bom", x, w)
