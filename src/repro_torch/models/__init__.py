"""The LM stack for serving: RecurrentGemma (RG-LRU + local attention) and
RWKV-6 run through the port's kernels."""
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
    params_from_reference,
    prefill,
)

__all__ = [
    "ArchConfig",
    "LayerSpec",
    "LMParams",
    "count_params",
    "decode_step",
    "forward_hidden",
    "init_decode_state",
    "init_params",
    "layer_specs",
    "params_from_reference",
    "prefill",
]
