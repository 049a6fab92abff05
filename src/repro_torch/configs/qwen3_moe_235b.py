"""Qwen3-MoE-235B-A22B [moe] — 128 experts, top-8, qk-norm.

94L d_model=4096 64H kv=4 head_dim=128 d_ff_expert=1536 vocab=151936
[hf:Qwen]. Expert parallelism shards the 128 experts over the model axis.
Full attention → long_500k skipped.
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        vocab=151936, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, pattern=(LayerSpec(kind="attn", ffn="moe"),), repeats=94,
        ffn_act="swiglu", norm="rmsnorm", qk_norm=True,
        rope_theta=1_000_000.0, tie_embeddings=False,
        n_experts=128, top_k=8, d_ff_expert=1536, capacity_factor=1.25,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, pattern=(LayerSpec(kind="attn", ffn="moe"),), repeats=2,
        ffn_act="swiglu", norm="rmsnorm", qk_norm=True,
        tie_embeddings=False,
        n_experts=8, top_k=2, d_ff_expert=64, capacity_factor=1.5,
        loss_chunk=64,
    )
