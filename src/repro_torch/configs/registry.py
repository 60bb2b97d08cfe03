"""--arch registry: the 10 assigned architectures (exact public configs).

Sources are cited per entry; `[...]` verification tiers follow the
assignment sheet.  A copy of ``repro.configs.registry``: the PyTorch port
keeps its own so that it imports nothing of the JAX package.  The port's
CPU tests run ``reduced`` configs; ``chip_smoke.py`` serves the full
``tinyllama-1.1b`` config on the card.
"""
from __future__ import annotations

from .base import ArchConfig

ARCHS = {
    # [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242; hf]
    "zamba2-2.7b": ArchConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6),
    # [audio] enc-dec, conv frontend stub [arXiv:2212.04356]
    "whisper-large-v3": ArchConfig(
        name="whisper-large-v3", family="encdec", n_layers=32, d_model=1280,
        n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
        n_enc_layers=32, frontend="audio"),
    # [moe] Kimi K2 trillion-param MoE [arXiv:2501.kimi2]
    "kimi-k2-1t-a32b": ArchConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, d_ff=0, vocab=163840,
        n_experts=384, top_k=8, d_ff_expert=2048, n_shared_experts=1,
        first_dense_layers=1),
    # [moe] 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]
    "arctic-480b": ArchConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=0, vocab=32000,
        n_experts=128, top_k=2, d_ff_expert=4864, residual_ff=4864),
    # [dense] 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]
    "mistral-nemo-12b": ArchConfig(
        name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, d_head=128,
        rope_theta=1e6),
    # [dense] GQA 128k vocab [arXiv:2407.21783]
    "llama3-405b": ArchConfig(
        name="llama3-405b", family="dense", n_layers=126, d_model=16384,
        n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
        rope_theta=5e5),
    # [dense] llama2-arch small [arXiv:2401.02385]
    "tinyllama-1.1b": ArchConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000),
    # [dense] RoPE, GQA kv=2 [hf:THUDM/glm-4-9b]
    "glm4-9b": ArchConfig(
        name="glm4-9b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552),
    # [ssm] SSD state-space duality [arXiv:2405.21060]
    "mamba2-130m": ArchConfig(
        name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2,
        tie_embeddings=True),      # mamba2-130m ties embed/lm_head
    # [vlm] M-RoPE, dynamic resolution backbone [arXiv:2409.12191]
    "qwen2-vl-72b": ArchConfig(
        name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
        rope_theta=1e6, mrope=True, frontend="vision"),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
