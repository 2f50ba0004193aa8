"""Configuration schema of the LM architecture pool, and the input shapes.

One ``<arch>.py`` per architecture lives beside this module; each exposes
``CONFIG`` (the published size) and ``SMOKE`` (a reduced one that runs a
real forward and decode on the CPU).  Field for field the reference's
``repro.configs.base``.  The FNO-family configs are in ``fno_paper.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMArchConfig:
    """Unified description of the LM-family architecture pool."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0             # shared (always-on) experts
    moe_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    mla_kv_lora: int = 0            # 0 => standard GQA attention
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128
    mla_v_dim: int = 128

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64

    # --- mixer selection ---
    mixer: str = "attn"             # attn | ssd | hymba (parallel attn+ssd)
    attn_window: int = 0            # 0 = full attention; >0 = sliding window
    n_full_attn_layers: int = 0     # hymba: this many layers get full attn

    # --- encoder-decoder (whisper) ---
    encoder_decoder: bool = False
    dec_layers: int = 0
    max_dec_len: int = 448

    # --- modality frontend stubs ---
    frontend: str = "none"          # none | audio_stub | vision_stub
    n_patches: int = 0              # vlm: image patch embeddings prepended

    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid-with-SWA)."""
        return self.mixer in ("ssd", "hymba")

    def params_dense_approx(self) -> int:
        """6ND napkin-math helper (N below)."""
        d, L = self.d_model, self.n_layers
        attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd + self.n_heads * self.hd * d
        if self.moe_experts:
            ff = self.moe_experts * 3 * d * self.moe_ff + self.moe_shared * 3 * d * self.moe_ff
        else:
            ff = 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total_layers = L + (self.dec_layers if self.encoder_decoder else 0)
        return total_layers * (attn + ff) + emb

    def active_params_approx(self) -> int:
        if not self.moe_experts:
            return self.params_dense_approx()
        d, L = self.d_model, self.n_layers
        attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd + self.n_heads * self.hd * d
        ff = (self.moe_top_k + self.moe_shared) * 3 * d * self.moe_ff
        emb = self.vocab * d
        return L * (attn + ff) + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: LMArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell, with a reason if not.

    long_500k needs sub-quadratic attention (skip pure full-attention
    archs, per the assignment); encoder-only archs would skip decode —
    every arch in this pool has a decoder, so only the long_500k rule and
    the whisper decoder-length cap apply.
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k decode is the quadratic regime (skip per assignment)"
    return True, ""
