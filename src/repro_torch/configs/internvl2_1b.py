"""InternVL2-1B [vlm] — InternViT frontend STUBBED + Qwen2-0.5B-class LM.

24L d_model=896 14H kv=2 d_ff=4864 vocab=151655 [arXiv:2404.16821; hf].
``input_specs`` provides precomputed (B, 256, d) patch embeddings which
overwrite the leading token positions (backbone-only per the assignment).
Full attention → long_500k skipped.
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    # vocab padded 151655 → 151680 (= 1185·128) for tp-divisible embedding
    return ArchConfig(
        name="internvl2-1b",
        vocab=151680, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, pattern=(LayerSpec(kind="attn"),), repeats=24,
        ffn_act="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=1_000_000.0, tie_embeddings=True,
        frontend="vision_stub", num_patches=256,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, pattern=(LayerSpec(kind="attn"),), repeats=2,
        ffn_act="swiglu", norm="rmsnorm", qkv_bias=True,
        tie_embeddings=True, frontend="vision_stub", num_patches=8,
        loss_chunk=64,
    )
