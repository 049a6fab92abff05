"""RWKV6-7B "Finch" [ssm] — attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536 [arXiv:2404.05892; hf].
head_size=64 (64 WKV heads).
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        vocab=65536, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, pattern=(LayerSpec(kind="rwkv", ffn="none"),), repeats=32,
        norm="layernorm", rwkv_head_size=64, tie_embeddings=False,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=224, pattern=(LayerSpec(kind="rwkv", ffn="none"),), repeats=2,
        norm="layernorm", rwkv_head_size=16, tie_embeddings=False, loss_chunk=64,
    )
