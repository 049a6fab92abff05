"""Gemma3-12B [dense] — 5:1 local:global attention interleave, 128k context.

48L d_model=3840 16H kv=8 d_ff=15360 vocab=262144 [hf:google/gemma-3].
head_dim=256, GeGLU, qk-norm, pre+post norms, embedding scaling, local
window 1024 @ theta 10k, global layers @ theta 1M.
"""
from repro_torch.models import ArchConfig, LayerSpec

_LOCAL = LayerSpec(kind="attn", window=1024, rope_theta=10_000.0)
_GLOBAL = LayerSpec(kind="attn", rope_theta=1_000_000.0)


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-12b",
        vocab=262144, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=15360, pattern=(_LOCAL,) * 5 + (_GLOBAL,), repeats=8,
        ffn_act="geglu", norm="rmsnorm", post_norm=True, qk_norm=True,
        embed_scale=True, tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    local = LayerSpec(kind="attn", window=16, rope_theta=10_000.0)
    glob = LayerSpec(kind="attn", rope_theta=1_000_000.0)
    return ArchConfig(
        name="gemma3-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, pattern=(local,) * 2 + (glob,), repeats=2,
        ffn_act="geglu", norm="rmsnorm", post_norm=True, qk_norm=True,
        embed_scale=True, tie_embeddings=True, loss_chunk=64,
    )
