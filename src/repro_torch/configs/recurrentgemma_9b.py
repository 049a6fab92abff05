"""RecurrentGemma-9B [hybrid] — Griffin: RG-LRU + local attention, 2:1.

38L d_model=4096 16H kv=1 (MQA) d_ff=12288 vocab=256000 [arXiv:2402.19427].
Pattern (rec, rec, attn-window-2048) × 12 + (rec, rec) tail = 38 layers.
"""
from repro_torch.models import ArchConfig, LayerSpec

_REC = LayerSpec(kind="rglru")
_ATTN = LayerSpec(kind="attn", window=2048)


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        vocab=256000, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, pattern=(_REC, _REC, _ATTN), repeats=12,
        tail=(_REC, _REC),
        ffn_act="geglu", norm="rmsnorm", embed_scale=True,
        rope_theta=10_000.0, lru_width=4096, conv_width=4,
        tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    rec = LayerSpec(kind="rglru")
    attn = LayerSpec(kind="attn", window=16)
    return ArchConfig(
        name="recurrentgemma-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, pattern=(rec, rec, attn), repeats=2, tail=(rec, rec),
        ffn_act="geglu", norm="rmsnorm", embed_scale=True,
        lru_width=64, conv_width=4, tie_embeddings=True, loss_chunk=64,
    )
