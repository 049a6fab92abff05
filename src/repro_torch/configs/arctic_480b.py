"""Snowflake Arctic-480B [moe] — 128 experts top-2 + parallel dense residual.

35L d_model=7168 56H kv=8 d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base]. The dense-residual FFN runs in
parallel with the MoE branch and is summed. 480B params → bf16 storage +
Adafactor (factored optimizer state) is the memory-binding choice
(EXPERIMENTS.md §Roofline). Full attention → long_500k skipped.
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b",
        vocab=32000, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=4864, pattern=(LayerSpec(kind="attn", ffn="moe"),), repeats=35,
        ffn_act="swiglu", norm="rmsnorm", rope_theta=10_000.0,
        tie_embeddings=False,
        n_experts=128, top_k=2, d_ff_expert=4864, moe_dense_residual=True,
        capacity_factor=1.25, param_dtype="bfloat16",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="arctic-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, pattern=(LayerSpec(kind="attn", ffn="moe"),), repeats=2,
        ffn_act="swiglu", norm="rmsnorm", tie_embeddings=False,
        n_experts=8, top_k=2, d_ff_expert=96, moe_dense_residual=True,
        capacity_factor=1.5, loss_chunk=64,
    )
