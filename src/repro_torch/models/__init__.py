"""The LM stack: the dense transformers, mixture-of-experts (Qwen3-MoE,
Arctic), the encoder-decoder (whisper), the vision-stub LM (InternVL),
RecurrentGemma (RG-LRU + local attention) and RWKV-6, served and trained
through the port's kernels."""
from repro_torch.models.moe import aux_load_balance_loss, init_moe, moe_apply
from repro_torch.models.transformer import (
    ArchConfig,
    LayerSpec,
    LMParams,
    count_params,
    decode_step,
    forward_hidden,
    init_decode_state,
    init_params,
    layer_specs,
    lm_loss,
    params_from_reference,
    params_to_reference,
    prefill,
    train_loss,
)

__all__ = [
    "ArchConfig",
    "LayerSpec",
    "LMParams",
    "aux_load_balance_loss",
    "count_params",
    "decode_step",
    "forward_hidden",
    "init_decode_state",
    "init_moe",
    "init_params",
    "layer_specs",
    "lm_loss",
    "moe_apply",
    "params_from_reference",
    "params_to_reference",
    "prefill",
    "train_loss",
]
