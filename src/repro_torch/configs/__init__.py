"""Architecture configs (public-literature specs), copied from the JAX
package's ``configs/``.

``get_config(arch_id)`` returns the FULL ArchConfig as assigned;
``get_smoke_config(arch_id)`` a reduced config of the same family for CPU
tests. The port carries all ten architectures of the JAX package: the dense
transformers (Qwen2-1.5B, TinyLlama-1.1B, Gemma-2B, Gemma3-12B), the
mixture-of-experts (Qwen3-MoE-235B, Arctic-480B), whisper-medium's
encoder-decoder and InternVL2-1B's LM behind its vision stub (flash
attention), RecurrentGemma-9B (flash attention and RG-LRU) and RWKV6-7B
(RWKV-6). An unknown id raises KeyError. ``SHAPES`` defines the four
input-shape cells and ``live_cells()`` enumerates the 34 (arch × shape)
combinations that run (the JAX package's; long_500k only for the archs
whose attention is not fully global, DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "qwen2_1_5b",
    "gemma3_12b",
    "tinyllama_1_1b",
    "gemma_2b",
    "rwkv6_7b",
    "whisper_medium",
    "recurrentgemma_9b",
    "qwen3_moe_235b",
    "arctic_480b",
    "internvl2_1b",
)
PORTED = ARCH_IDS

# canonical external ids (dashes) → module names
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "qwen2-1.5b": "qwen2_1_5b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "arctic-480b": "arctic_480b",
    "internvl2-1b": "internvl2_1b",
})


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# Archs whose attention is fully quadratic-global skip long_500k (DESIGN §4).
LONG_CONTEXT_ARCHS = {"gemma3_12b", "rwkv6_7b", "recurrentgemma_9b"}


def live_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            cells.append((arch, shape))
    return cells


def resolve(arch_id: str) -> str:
    return _ALIASES.get(arch_id, arch_id)


def _module(arch_id: str):
    name = resolve(arch_id)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()
