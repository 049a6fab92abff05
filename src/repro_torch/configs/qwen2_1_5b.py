"""Qwen2-1.5B [dense] — GQA (kv=2), QKV bias, tied embeddings.

28L d_model=1536 12H kv=2 d_ff=8960 vocab=151936 [arXiv:2407.10671; hf].
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-1.5b",
        vocab=151936, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, pattern=(LayerSpec(kind="attn"),), repeats=28,
        ffn_act="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=1_000_000.0, tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, pattern=(LayerSpec(kind="attn"),), repeats=2,
        ffn_act="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=1_000_000.0, tie_embeddings=True, loss_chunk=64,
    )
