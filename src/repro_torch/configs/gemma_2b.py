"""Gemma-2B [dense] — GeGLU, head_dim=256, MQA (kv=1).

18L d_model=2048 8H kv=1 d_ff=16384 vocab=256000 [arXiv:2403.08295; hf].
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b",
        vocab=256000, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, pattern=(LayerSpec(kind="attn"),), repeats=18,
        ffn_act="geglu", norm="rmsnorm", embed_scale=True,
        rope_theta=10_000.0, tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, pattern=(LayerSpec(kind="attn"),), repeats=2,
        ffn_act="geglu", norm="rmsnorm", embed_scale=True,
        tie_embeddings=True, loss_chunk=64,
    )
