"""TinyLlama-1.1B [dense] — llama2-architecture small model.

22L d_model=2048 32H kv=4 d_ff=5632 vocab=32000 [arXiv:2401.02385; hf].
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b",
        vocab=32000, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
        d_ff=5632, pattern=(LayerSpec(kind="attn"),), repeats=22,
        ffn_act="swiglu", norm="rmsnorm", rope_theta=10_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-smoke",
        vocab=512, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, pattern=(LayerSpec(kind="attn"),), repeats=2,
        ffn_act="swiglu", norm="rmsnorm", tie_embeddings=False, loss_chunk=64,
    )
