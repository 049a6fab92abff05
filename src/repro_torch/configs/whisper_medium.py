"""Whisper-medium [audio] — encoder-decoder; conv frontend STUBBED.

24L (decoder; +24 encoder) d_model=1024 16H kv=16 d_ff=4096 vocab=51865
[arXiv:2212.04356]. ``input_specs`` provides precomputed (B, 1500, d) frame
embeddings (post-conv). Learned absolute positions — the real model caps at
448 decoder positions; for the 32k decode shape the table is grown via
``dataclasses.replace(cfg, max_position=seq_len)`` (shape-faithful, not
weight-faithful — DESIGN.md §4). Full-attention decoder → long_500k skipped.
"""
from repro_torch.models import ArchConfig, LayerSpec


def config() -> ArchConfig:
    # vocab padded 51865 → 51968 (= 406·128) so the tp-sharded embedding
    # divides any power-of-two mesh axis; extra rows are never produced by
    # the tokenizer (standard framework practice)
    return ArchConfig(
        name="whisper-medium",
        vocab=51968, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096,
        pattern=(LayerSpec(kind="attn", cross_attn=True),), repeats=24,
        ffn_act="gelu", norm="layernorm", learned_pos=True, max_position=448,
        encoder_layers=24, encoder_seq=1500, frontend="audio_stub",
        tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-smoke",
        vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128,
        pattern=(LayerSpec(kind="attn", cross_attn=True),), repeats=2,
        ffn_act="gelu", norm="layernorm", learned_pos=True, max_position=128,
        encoder_layers=2, encoder_seq=24, frontend="audio_stub",
        tie_embeddings=True, loss_chunk=64,
    )
