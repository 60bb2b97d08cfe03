"""Architecture configuration dataclass + input-shape sets.

A copy of ``repro.configs.base`` for the PyTorch port; ``registry.py`` maps
``--arch`` ids to one :class:`ArchConfig` each.  The dataclass is
hashable (frozen) so model functions can take it as a static argument.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    residual_ff: int = 0           # arctic: parallel dense-residual MLP width
    first_dense_layers: int = 0    # kimi: leading dense layers
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (zamba2) ---
    attn_every: int = 0            # shared attention block period (0 = none)

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0          # 0 -> decoder-only
    frontend: Optional[str] = None # "audio" | "vision" stub frontends

    # --- VLM ---
    mrope: bool = False            # 3-section rotary (M-RoPE)

    # --- attention behaviour ---
    sliding_window: int = 0        # 0 = full attention

    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_headdim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stacked blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d                     # embedding
        if not self.tie_embeddings:
            total += d * v                # lm head (untied)
        total += d                        # final norm
        blocks = 0
        hd = self.head_dim() if self.n_heads else 0
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d + 2 * d
        dense_mlp = 3 * d * self.d_ff + d if self.d_ff else 0
        if self.family in ("dense", "vlm"):
            blocks = self.n_layers * (attn + dense_mlp)
        elif self.family == "moe":
            moe_mlp = 3 * d * self.d_ff_expert * self.n_experts
            moe_mlp += self.n_shared_experts * 3 * d * self.d_ff_expert
            moe_mlp += d * self.n_experts          # router
            moe_mlp += 3 * d * self.residual_ff    # arctic dense residual
            moe_mlp += d
            n_moe = self.n_layers - self.first_dense_layers
            blocks = n_moe * (attn + moe_mlp) \
                + self.first_dense_layers * (attn + dense_mlp)
        elif self.family == "ssm":
            blocks = self.n_layers * self._ssm_block_params()
        elif self.family == "hybrid":
            blocks = self.n_layers * self._ssm_block_params()
            blocks += attn + dense_mlp             # one shared attn block
        elif self.family == "encdec":
            enc_blocks = self.n_enc_layers * (attn + dense_mlp)
            dec_blocks = self.n_layers * (2 * attn + dense_mlp)
            blocks = enc_blocks + dec_blocks
        return total + blocks

    def _ssm_block_params(self) -> int:
        d, di, n, h = self.d_model, self.d_inner, self.ssm_state, self.ssm_heads
        p = d * (2 * di + 2 * n + h)      # in_proj -> (x, z, B, C, dt)
        p += self.conv_width * (di + 2 * n)
        p += 2 * h                        # A_log, D
        p += di * d + 2 * d               # out_proj + norms
        return p

    def active_param_count(self) -> int:
        """6*N_active*D convention for MoE rooflines."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.head_dim()
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d + 2 * d
        act_mlp = 3 * d * self.d_ff_expert * (self.top_k + self.n_shared_experts)
        act_mlp += 3 * d * self.residual_ff + d * self.n_experts + d
        dense_mlp = 3 * d * self.d_ff + d if self.d_ff else 0
        n_moe = self.n_layers - self.first_dense_layers
        total = 2 * self.vocab * d + d
        return total + n_moe * (attn + act_mlp) \
            + self.first_dense_layers * (attn + dense_mlp)


@dataclasses.dataclass(frozen=True)
class ShapeSet:
    """One assigned (shape-id -> concrete shapes) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeSet, ...] = (
    ShapeSet("train_4k", 4096, 256, "train"),
    ShapeSet("prefill_32k", 32768, 32, "prefill"),
    ShapeSet("decode_32k", 32768, 128, "decode"),
    ShapeSet("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

# Archs whose attention is fully quadratic skip long_500k.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), d_ff=128,
        vocab=256, d_head=16)
    if cfg.family == "moe":
        base.update(n_experts=4, top_k=min(2, cfg.top_k), d_ff_expert=64,
                    n_shared_experts=min(1, cfg.n_shared_experts),
                    residual_ff=64 if cfg.residual_ff else 0,
                    first_dense_layers=min(1, cfg.first_dense_layers))
    if cfg.family in ("ssm", "hybrid"):
        base.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        base.update(attn_every=1)      # keep >=1 shared-attn application
    if cfg.family == "encdec":
        base.update(n_enc_layers=2)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
