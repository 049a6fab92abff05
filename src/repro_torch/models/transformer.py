"""The LM stack: config, init, training forward and loss, prefill and decode.

The port of the JAX package's ``models/transformer.py``:
  * An architecture is a repeated PATTERN of layer specs plus an optional
    tail (recurrentgemma: (rec, rec, attn) × 12 + (rec, rec)). The JAX
    package stacks each pattern position's parameters over the repeats and
    scans them; here the layers are applied in order, layer
    ``i·len(pattern) + j`` being repeat ``i`` of pattern position ``j``, the
    tail after them (:func:`layer_specs`).
  * Weights come in two layouts. :class:`LMParams` (an ``nn.Module``, one
    :class:`ParamTree` a layer) is what serving holds. The JAX package's
    tree (``blocks/b{j}`` stacked over the repeats, then ``tail{j}``, as
    nested dicts of tensors) is what training and checkpoints hold: the
    optimizers update it leaf by leaf as the reference does (Adafactor's
    factored moments and its update clipping see a stacked leaf whole), and
    a checkpoint of it is the reference's. Every function here takes
    either; :func:`params_from_reference` and :func:`params_to_reference`
    convert.
  * :func:`train_loss` is the training forward (:func:`forward_hidden`,
    which records autograd's graph when grad mode is on) and the chunked
    cross-entropy :func:`lm_loss`, in which a (B, chunk, V) logits tensor
    is the largest that exists.
  * The decode state (KV caches, recurrent states) is a list with one dict
    per layer, updated in place by :func:`prefill` and :func:`decode_step`.
  * ``force`` is threaded down to ``ops`` so a caller can run the plain
    path on the card (``force="ref"``).
  * The encoder-decoder (whisper) runs a bidirectional encoder over the
    audio stub's frame embeddings (``batch["enc_embeds"]``, (B, Te, d)) and
    feeds its output to every decoder layer's cross-attention; the vision
    stub's ``batch["patch_embeds"]`` (B, P, d) overwrite the leading token
    embeddings; learned absolute positions are added to the embeddings.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import default_device
from repro_torch.models import recurrent
from repro_torch.models.attention import (
    AttnCfg,
    attn_decode,
    attn_prefill,
    attn_train,
    init_attention,
    init_kv_cache,
)
from repro_torch.models.layers import Init, ParamTree, ffn_apply, gathered, init_ffn, \
    init_norm, layernorm, mesh_matmul, multi_rank, rmsnorm
from repro_torch.models.moe import init_moe, moe_apply

__all__ = ["LayerSpec", "ArchConfig", "LMParams", "init_params", "params_from_reference",
           "params_to_reference", "forward_hidden", "lm_loss", "train_loss",
           "init_decode_state", "decode_step", "prefill", "count_params", "layer_specs"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"                 # "attn" | "rglru" | "rwkv"
    window: int | None = None          # sliding-window attention
    rope_theta: float | None = None    # per-layer RoPE override (gemma3 local)
    ffn: str = "dense"                 # "dense" | "moe" | "none"
    cross_attn: bool = False           # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    pattern: tuple[LayerSpec, ...]
    repeats: int
    tail: tuple[LayerSpec, ...] = ()
    ffn_act: str = "swiglu"            # "swiglu" | "geglu" | "gelu"
    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm"
    post_norm: bool = False            # gemma3: post-attn/post-ffn norms
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_scale: float | None = None
    attn_matmul: str = "float32"       # "input": bf16 QK/PV operands
    embed_scale: bool = False          # scale embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    # --- recurrent ---
    lru_width: int = 0
    conv_width: int = 4
    rwkv_head_size: int = 64
    # --- encoder-decoder / frontends ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    learned_pos: bool = False
    max_position: int = 0
    frontend: str = "none"             # "none" | "audio_stub" | "vision_stub"
    num_patches: int = 0
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 512              # sequence chunk of the cross-entropy

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats + len(self.tail)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def attn_cfg(self, spec: LayerSpec, cross: bool = False) -> AttnCfg:
        return AttnCfg(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            bias=self.qkv_bias, qk_norm=self.qk_norm,
            window=None if cross else spec.window,
            rope_theta=(None if self.learned_pos
                        else (spec.rope_theta or self.rope_theta)),
            logit_softcap=self.attn_softcap, scale=self.attn_scale,
            cross=cross, matmul_dtype=self.attn_matmul,
        )


# the encoder's layers: bidirectional attention and a dense FFN
_ENC_SPEC = LayerSpec(kind="attn", ffn="dense")


def layer_specs(cfg: ArchConfig) -> list[LayerSpec]:
    """Every layer's spec, in the order the stack applies them."""
    return list(cfg.pattern) * cfg.repeats + list(cfg.tail)


class LMParams(nn.Module):
    """The weights of one LM: ``embed``, ``layers`` (an ``nn.ModuleList`` of
    :class:`ParamTree`, one per layer in order), ``final_norm``, and where
    the config has them ``lm_head`` (untied embeddings), ``pos_embed``
    (learned positions), ``encoder`` (one :class:`ParamTree` per encoder
    layer) and ``enc_norm``; absent ones are None."""

    def __init__(self, embed: torch.Tensor, layers: list[dict], final_norm: dict,
                 lm_head: torch.Tensor | None = None, *, pos_embed: torch.Tensor | None = None,
                 encoder: list[dict] | None = None, enc_norm: dict | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(ParamTree(p) for p in layers)
        self.final_norm = ParamTree(final_norm)
        self.lm_head = (nn.Parameter(lm_head, requires_grad=False)
                        if lm_head is not None else None)
        self.pos_embed = (nn.Parameter(pos_embed, requires_grad=False)
                          if pos_embed is not None else None)
        self.encoder = (nn.ModuleList(ParamTree(p) for p in encoder)
                        if encoder is not None else None)
        self.enc_norm = ParamTree(enc_norm) if enc_norm is not None else None


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(init: Init, cfg: ArchConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    p: dict = {"norm1": init_norm(init, d, cfg.norm)}
    if spec.kind == "attn":
        p["attn"] = init_attention(init, cfg.attn_cfg(spec))
    elif spec.kind == "rglru":
        p["rec"] = recurrent.init_rglru_block(init, d, cfg.lru_width or d, cfg.conv_width)
    elif spec.kind == "rwkv":
        p.update(recurrent.init_rwkv_block(init, d, cfg.d_ff, cfg.rwkv_head_size))
        p["norm2"] = init_norm(init, d, cfg.norm)
        return p
    else:
        raise ValueError(f"unknown layer kind {spec.kind!r}")
    if cfg.post_norm:
        p["norm1b"] = init_norm(init, d, cfg.norm)
    if spec.cross_attn:
        p["normx"] = init_norm(init, d, cfg.norm)
        p["xattn"] = init_attention(init, cfg.attn_cfg(spec, cross=True))
    if spec.ffn != "none":
        p["norm2"] = init_norm(init, d, cfg.norm)
        if spec.ffn == "moe":
            p["moe"] = init_moe(
                init, d, cfg.n_experts, cfg.d_ff_expert, act=cfg.ffn_act,
                dense_residual_ff=cfg.d_ff if cfg.moe_dense_residual else 0)
        else:
            p["ffn"] = init_ffn(init, d, cfg.d_ff, cfg.ffn_act)
        if cfg.post_norm:
            p["norm2b"] = init_norm(init, d, cfg.norm)
    return p


def _init_enc_layer(init: Init, cfg: ArchConfig) -> dict:
    """Whisper-style bidirectional encoder layer: MHA + GELU FFN."""
    d = cfg.d_model
    return {
        "norm1": init_norm(init, d, cfg.norm),
        "attn": init_attention(init, cfg.attn_cfg(_ENC_SPEC)),
        "norm2": init_norm(init, d, cfg.norm),
        "ffn": init_ffn(init, d, cfg.d_ff, cfg.ffn_act),
    }


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> LMParams:
    """Random weights drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` and moved one tensor at a time to ``device`` (the card by
    default), with the JAX package's shapes and scales: one seed gives the
    same weights on every device. PyTorch's draws differ from
    ``jax.random``'s: to run the JAX package's weights use
    :func:`params_from_reference`."""
    dev = default_device(device)
    return _draw_params(Init(torch.Generator().manual_seed(seed), cfg.pdtype, dev), cfg)


def _draw_params(init: Init, cfg: ArchConfig) -> LMParams:
    """Every weight of ``cfg`` from ``init``, in one fixed order."""
    # σ = d^-1/2 keeps TIED unembed logits O(1)
    embed = init.normal((cfg.vocab, cfg.d_model), stddev=cfg.d_model ** -0.5)
    extra = {}
    if cfg.learned_pos:
        extra["pos_embed"] = init.normal((max(cfg.max_position, 1), cfg.d_model), stddev=0.02)
    if cfg.encoder_layers:
        extra["encoder"] = [_init_enc_layer(init, cfg) for _ in range(cfg.encoder_layers)]
        extra["enc_norm"] = init_norm(init, cfg.d_model, cfg.norm)
    layers = [_init_layer(init, cfg, spec) for spec in layer_specs(cfg)]
    final_norm = init_norm(init, cfg.d_model, cfg.norm)
    lm_head = None if cfg.tie_embeddings else init.normal((cfg.d_model, cfg.vocab))
    return LMParams(embed, layers, final_norm, lm_head, **extra)


def params_from_reference(cfg: ArchConfig, tree: dict, device=None) -> LMParams:
    """The JAX package's parameter pytree (``repro.models.init_params``), as
    nested dicts of numpy arrays or tensors, as the port's weights on
    ``device``.

    ``blocks/b{j}`` holds pattern position ``j`` stacked over the repeats:
    its leaf ``[i]`` becomes layer ``i·len(pattern) + j``; ``tail{j}``
    follows the stacked layers. ``encoder`` is stacked over the encoder
    layers; ``pos_embed`` and ``enc_norm`` are carried as they are."""
    dev = default_device(device)

    def tensors(node, index=None):
        if isinstance(node, dict):
            return {k: tensors(v, index) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            t = node if index is None else node[index]
            return t.detach().to(dev, copy=True)
        arr = np.asarray(node if index is None else node[index])
        return torch.from_numpy(np.array(arr)).to(dev)

    n_pat = len(cfg.pattern)
    layers = [tensors(tree["blocks"][f"b{j}"], i)
              for i in range(cfg.repeats) for j in range(n_pat)]
    layers += [tensors(tree[f"tail{j}"]) for j in range(len(cfg.tail))]
    lm_head = None if cfg.tie_embeddings else tensors(tree["lm_head"])
    extra = {}
    if "pos_embed" in tree:
        extra["pos_embed"] = tensors(tree["pos_embed"])
    if "encoder" in tree:
        extra["encoder"] = [tensors(tree["encoder"], i) for i in range(cfg.encoder_layers)]
        extra["enc_norm"] = tensors(tree["enc_norm"])
    return LMParams(tensors(tree["embed"]), layers, tensors(tree["final_norm"]), lm_head,
                    **extra)


def _as_dict(node) -> dict:
    """A ParamTree (or dict) as nested dicts of detached tensors."""
    if isinstance(node, ParamTree):
        out = {k: v.detach() for k, v in node._parameters.items()}
        out.update({k: _as_dict(m) for k, m in node._modules.items()})
        return out
    return {k: _as_dict(v) if isinstance(v, (dict, ParamTree)) else v.detach()
            for k, v in node.items()}


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def params_to_reference(cfg: ArchConfig, params: LMParams) -> dict:
    """The inverse of :func:`params_from_reference`: the JAX package's tree
    (``embed``, ``pos_embed``, ``encoder`` stacked over the encoder layers,
    ``enc_norm``, ``blocks/b{j}`` stacked over the repeats, ``tail{j}``,
    ``final_norm``, ``lm_head`` when untied) as nested dicts of tensors on
    the weights' device."""
    if isinstance(params, dict):
        return params
    layers = [_as_dict(p) for p in params.layers]
    n_pat, n_stacked = len(cfg.pattern), len(cfg.pattern) * cfg.repeats
    tree = {"embed": params.embed.detach()}
    if params.pos_embed is not None:
        tree["pos_embed"] = params.pos_embed.detach()
    if params.encoder is not None:
        tree["encoder"] = _stack([_as_dict(p) for p in params.encoder])
        tree["enc_norm"] = _as_dict(params.enc_norm)
    tree["blocks"] = {f"b{j}": _stack(layers[j:n_stacked:n_pat]) for j in range(n_pat)}
    for j in range(len(cfg.tail)):
        tree[f"tail{j}"] = layers[n_stacked + j]
    tree["final_norm"] = _as_dict(params.final_norm)
    if not cfg.tie_embeddings:
        tree["lm_head"] = params.lm_head.detach()
    return tree


def _unbind(node, repeats: int) -> list:
    """A stacked subtree as ``repeats`` per-layer subtrees of views (one
    ``unbind`` a leaf, so a backward stacks each leaf's gradient once)."""
    if isinstance(node, dict):
        subs = {k: _unbind(v, repeats) for k, v in node.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(repeats)]
    return list(torch.unbind(node))


class _TreeView:
    """The JAX package's tree read as :class:`LMParams` reads: ``embed``,
    ``layers`` in order, ``final_norm``, ``lm_head``, ``pos_embed``,
    ``encoder`` in order, ``enc_norm``."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        self.embed = tree["embed"]
        per_pos = [_unbind(tree["blocks"][f"b{j}"], cfg.repeats)
                   for j in range(len(cfg.pattern))]
        self.layers = [pos[i] for i in range(cfg.repeats) for pos in per_pos]
        self.layers += [tree[f"tail{j}"] for j in range(len(cfg.tail))]
        self.final_norm = tree["final_norm"]
        self.lm_head = tree.get("lm_head")
        self.pos_embed = tree.get("pos_embed")
        self.encoder = (_unbind(tree["encoder"], cfg.encoder_layers)
                        if "encoder" in tree else None)
        self.enc_norm = tree.get("enc_norm")


def _view(cfg: ArchConfig, params):
    return _TreeView(cfg, params) if isinstance(params, dict) else params


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def count_params(params) -> int:
    """Parameters of :class:`LMParams` or of the JAX package's tree."""
    leaves = _leaves(params) if isinstance(params, dict) else params.parameters()
    return sum(p.numel() for p in leaves)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _norm(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


class _BatchSharded(torch.autograd.Function):
    """``x`` redistributed to ``placements``; its gradient sharded as ``x``
    was (as ``placements`` where ``x`` was a partial sum). Left to
    DTensor, the gradient of a sum over a sharded dimension comes back
    whole (a broadcast scalar), and every backward product after it would
    run on the whole batch, or the whole vocabulary, on every rank."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Partial

        partial = any(isinstance(p, Partial) for p in x.placements)
        ctx.placements = placements if partial else x.placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def _batch_sharded(x: torch.Tensor) -> torch.Tensor:
    """On a mesh, the residual stream ``x`` (B, T, d) as the layers pass it
    on: the batch over the data dimension (where it divides), whole on
    ``model``, in the forward and in the backward. Left to itself DTensor's
    propagation may split the sequence over ``model`` after a row-parallel
    product, and then fold it into the batch in the next product's
    flattening; fixing the layout at each block's entry keeps every product
    a plain column- or row-parallel one. A plain tensor is returned as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pls = tuple(Replicate() if name == "model" or x.shape[0] % n else Shard(0)
                for name, n in zip(mesh.mesh_dim_names, mesh.shape))
    return _BatchSharded.apply(x, pls)


def _ffn_block(cfg: ArchConfig, spec: LayerSpec, p, x: torch.Tensor) -> torch.Tensor:
    if spec.ffn == "none":
        return x
    x = _batch_sharded(x)
    h = _norm(cfg, p["norm2"], x)
    if spec.ffn == "moe":
        h = moe_apply(p["moe"], h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                      act=cfg.ffn_act)
    else:
        h = ffn_apply(p["ffn"], h, cfg.ffn_act)
    if cfg.post_norm:
        h = _norm(cfg, p["norm2b"], h)
    return x + h


def _rwkv_layer(cfg: ArchConfig, p, x: torch.Tensor, st: dict | None, force):
    x = _batch_sharded(x)
    t_out, tstate = recurrent.rwkv_time_mix(p, _norm(cfg, p["norm1"], x), st,
                                            cfg.rwkv_head_size, force=force)
    x = _batch_sharded(x + t_out)
    c_out, cstate = recurrent.rwkv_channel_mix(p, _norm(cfg, p["norm2"], x), st)
    return x + c_out, {**tstate, **cstate}


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p, x: torch.Tensor,
                 positions: torch.Tensor, memory: torch.Tensor | None, force) -> torch.Tensor:
    x = _batch_sharded(x)
    if spec.kind == "rwkv":
        return _rwkv_layer(cfg, p, x, None, force)[0]
    h = _norm(cfg, p["norm1"], x)
    if spec.kind == "attn":
        h = attn_train(p["attn"], cfg.attn_cfg(spec), h, positions, force=force)
    else:
        h, _ = recurrent.rglru_block_apply(p["rec"], h, force=force)
    if cfg.post_norm:
        h = _norm(cfg, p["norm1b"], h)
    x = x + h
    if spec.cross_attn:
        x = x + attn_train(p["xattn"], cfg.attn_cfg(spec, cross=True),
                           _norm(cfg, p["normx"], x), positions, memory, force=force)
    return _ffn_block(cfg, spec, p, x)


def _prefill_layer(cfg: ArchConfig, spec: LayerSpec, p, st: dict, x: torch.Tensor,
                   positions: torch.Tensor, memory: torch.Tensor | None,
                   force) -> torch.Tensor:
    """One layer over the prompt; fills ``st`` in place."""
    x = _batch_sharded(x)
    if spec.kind == "rwkv":
        x, st["rwkv"] = _rwkv_layer(cfg, p, x, None, force)
        return x
    h = _norm(cfg, p["norm1"], x)
    if spec.kind == "attn":
        h, st["kv"] = attn_prefill(p["attn"], cfg.attn_cfg(spec), h, positions, st["kv"],
                                   force=force)
    else:
        h, st["rec"] = recurrent.rglru_block_apply(p["rec"], h, None, force=force)
    if cfg.post_norm:
        h = _norm(cfg, p["norm1b"], h)
    x = x + h
    if spec.cross_attn:
        h, st["xkv"] = attn_prefill(p["xattn"], cfg.attn_cfg(spec, cross=True),
                                    _norm(cfg, p["normx"], x), positions, st["xkv"],
                                    memory, force=force)
        x = x + h
    return _ffn_block(cfg, spec, p, x)


def _decode_layer(cfg: ArchConfig, spec: LayerSpec, p, st: dict, x: torch.Tensor,
                  pos: int, force) -> torch.Tensor:
    """One layer for one token; updates ``st`` in place."""
    x = _batch_sharded(x)
    if spec.kind == "rwkv":
        x, st["rwkv"] = _rwkv_layer(cfg, p, x, st["rwkv"], force)
        return x
    h = _norm(cfg, p["norm1"], x)
    if spec.kind == "attn":
        h, st["kv"] = attn_decode(p["attn"], cfg.attn_cfg(spec), h, pos, st["kv"])
    else:
        h, st["rec"] = recurrent.rglru_block_apply(p["rec"], h, st["rec"], force=force)
    if cfg.post_norm:
        h = _norm(cfg, p["norm1b"], h)
    x = x + h
    if spec.cross_attn:
        h, _ = attn_decode(p["xattn"], cfg.attn_cfg(spec, cross=True),
                           _norm(cfg, p["normx"], x), pos, st["xkv"])
        x = x + h
    return _ffn_block(cfg, spec, p, x)


# ---------------------------------------------------------------------------
# Full sequence, prefill, decode
# ---------------------------------------------------------------------------

def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``. On a mesh (DTensors) it is the vocabulary-parallel
    lookup under ``local_map``: each ``model`` rank looks up the tokens in
    its rows of the table (zero for the others), a partial sum over
    ``model``; DTensor's own rule for a vocabulary-sharded table fails on
    a batch sharded over the data dimension. A table whose rows do not
    divide ``model`` is gathered first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(embed, DTensor):
        return F.embedding(tokens, embed)
    mesh = embed.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    tp = sizes.get("model", 1)
    split = tp > 1 and embed.shape[0] % tp == 0
    rows = embed.shape[0] // tp if split else embed.shape[0]
    tok_pl = [Replicate() if name == "model" or tokens.shape[0] % n else Shard(0)
              for name, n in zip(mesh.mesh_dim_names, mesh.shape)]
    tab_pl = [Shard(0) if name == "model" and split else Replicate()
              for name in mesh.mesh_dim_names]
    out_pl = [Partial() if name == "model" and split else p
              for name, p in zip(mesh.mesh_dim_names, tok_pl)]
    # a data rank's table gradient comes from its own tokens: a sum over data
    grad_pl = [Partial() if name != "model" and isinstance(p, Shard) else q
               for name, p, q in zip(mesh.mesh_dim_names, tok_pl, tab_pl)]

    def local(table, tok):
        lo = mesh.get_local_rank("model") * rows if split else 0
        own = (tok >= lo) & (tok < lo + rows)
        x = F.embedding(torch.where(own, tok - lo, 0), table)
        return torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))

    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return local_map(local, out_placements=out_pl, in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl),
                     redistribute_inputs=True)(embed, tokens)


def _embed(cfg: ArchConfig, params: LMParams, tokens: torch.Tensor) -> torch.Tensor:
    x = _lookup(params.embed, tokens).to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype, device=x.device)
    return x


def _tokens(params: LMParams, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device).long()


def _embed_inputs(cfg: ArchConfig, params: LMParams, batch: dict) -> torch.Tensor:
    """Token embeddings (scaled where the config says), the vision stub's
    patch embeddings over the leading positions, then learned positions."""
    x = _embed(cfg, params, _tokens(params, batch["tokens"]))
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        patches = torch.as_tensor(batch["patch_embeds"], device=x.device).to(cfg.cdtype)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    if cfg.learned_pos:
        x = x + params.pos_embed[:x.shape[1]][None].to(x.dtype)
    return x


def _sinusoid(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _run_encoder(cfg: ArchConfig, params: LMParams, enc_embeds, force) -> torch.Tensor:
    """Whisper encoder stack over the stub's frame embeddings (B, Te, d)."""
    x = torch.as_tensor(enc_embeds, device=params.embed.device).to(cfg.cdtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in params.encoder:
        x = _batch_sharded(x)
        x = x + attn_train(lp["attn"], cfg.attn_cfg(_ENC_SPEC), _norm(cfg, lp["norm1"], x),
                           positions, causal=False, force=force)
        x = x + ffn_apply(lp["ffn"], _norm(cfg, lp["norm2"], x), cfg.ffn_act)
    return _norm(cfg, params.enc_norm, _batch_sharded(x))


def _memory(cfg: ArchConfig, params: LMParams, batch: dict, force) -> torch.Tensor | None:
    return (_run_encoder(cfg, params, batch["enc_embeds"], force) if cfg.encoder_layers
            else None)


def _unembed(cfg: ArchConfig, params) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _project(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) final hidden → (..., vocab) float32 logits: the unembedding
    ``w`` is cast to the compute dtype and the product accumulates in
    float32, as the JAX package's ``preferred_element_type=float32`` does
    (on a mesh of more than one rank, its cross-rank sums too)."""
    w = w.to(x.dtype)
    logits = (mesh_matmul(x, w, torch.float32) if multi_rank(w)
              else torch.matmul(x.float(), w.float()))
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    return _project(cfg, x, gathered(_unembed(cfg, params)))


def _remat(fn, remat: str):
    """``fn`` recomputed in the backward: ``"full"`` keeps only the layer's
    input, ``"dots"`` keeps the products' outputs too (the reference's
    remat policies); ``"none"`` keeps everything."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        import functools

        from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

        products = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default}

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in products
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        ctx = functools.partial(create_selective_checkpoint_contexts, policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"unknown remat policy {remat!r}")


def forward_hidden(cfg: ArchConfig, params, batch: dict, *, force=None,
                   remat: str = "none") -> torch.Tensor:
    """Embeddings → stack → final norm. batch: ``{"tokens": (B, S)}`` and
    the stub inputs the config reads (``enc_embeds``, ``patch_embeds``).
    Records autograd's graph when grad mode is on and a weight requires
    grad (the training forward); the kernels' gradients go through
    ``ops``' plain versions."""
    params = _view(cfg, params)
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    memory = _memory(cfg, params, batch, force)
    layer = _remat(_apply_layer, remat)
    for spec, p in zip(layer_specs(cfg), params.layers):
        x = layer(cfg, spec, p, x, positions, memory, force)
    return _norm(cfg, params.final_norm, _batch_sharded(x))


def _chunk_loss(cfg: ArchConfig, h: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Summed masked CE of one (B, chunk) slice and its count of labels. On
    a mesh the chunk's logits are gathered over ``model`` (the vocabulary)
    before the gold logit's gather, which DTensor cannot take from a
    vocabulary-sharded operand."""
    logits = _batch_sharded(_project(cfg, h, w))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.clamp(min=0)[..., None])[..., 0]
    mask = (y >= 0).to(torch.float32)
    return torch.sum(_batch_sharded((lse - gold) * mask)), torch.sum(mask)


def lm_loss(cfg: ArchConfig, params, hidden: torch.Tensor, labels) -> torch.Tensor:
    """Mean next-token CE; labels < 0 are masked. The sequence goes in
    chunks of ``cfg.loss_chunk`` positions, each under activation
    checkpointing, so a (B, chunk, V) logits tensor is the largest that
    exists, in the backward too (it recomputes one chunk's logits at a
    time). The chunks and their float32 sums are the reference's."""
    w = gathered(_unembed(cfg, _view(cfg, params)))     # once, not a chunk
    labels = torch.as_tensor(labels, device=hidden.device).long()
    s = hidden.shape[1]
    chunk = min(cfg.loss_chunk, s)
    n_chunks = s // chunk
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s - n_chunks * chunk:
        bounds.append((n_chunks * chunk, s))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo, hi in bounds:
        part, n = checkpoint(_chunk_loss, cfg, hidden[:, lo:hi], labels[:, lo:hi], w,
                             use_reentrant=False)
        tot, cnt = tot + part, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(cfg: ArchConfig, params, batch: dict, *, force=None,
               remat: str = "none") -> torch.Tensor:
    """The training objective: :func:`lm_loss` of :func:`forward_hidden`.
    batch: ``{"tokens": (B, S), "labels": (B, S)}``."""
    hidden = forward_hidden(cfg, params, batch, force=force, remat=remat)
    return lm_loss(cfg, params, hidden, batch["labels"])


def _init_layer_state(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                      cache_dtype, device) -> dict:
    if spec.kind == "attn":
        st = {"kv": init_kv_cache(cfg.attn_cfg(spec), batch, max_len, cache_dtype, device)}
        if spec.cross_attn:
            st["xkv"] = init_kv_cache(cfg.attn_cfg(spec), batch, max(cfg.encoder_seq, 1),
                                      cache_dtype, device)
        return st
    if spec.kind == "rglru":
        return {"rec": recurrent.init_rglru_state(cfg.lru_width or cfg.d_model, batch,
                                                  cfg.conv_width, device=device)}
    return {"rwkv": recurrent.init_rwkv_state(cfg.d_model, batch, cfg.rwkv_head_size,
                                              device=device)}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device=None) -> list[dict]:
    """One state dict per layer, in layer order: ``{"kv": {"k", "v"}}``
    caches of (batch, n_kv_heads, max_len, head_dim) for attention (and
    ``"xkv"``, the encoder's K/V of ``encoder_seq`` positions, for
    cross-attention), ``{"rec": {"conv", "h"}}`` for RG-LRU, ``{"rwkv":
    {...}}`` for RWKV."""
    dev = default_device(device)
    return [_init_layer_state(cfg, spec, batch, max_len, cache_dtype, dev)
            for spec in layer_specs(cfg)]


@torch.no_grad()
def prefill(cfg: ArchConfig, params: LMParams, state: list[dict], batch: dict, *,
            force=None) -> tuple[torch.Tensor, list[dict]]:
    """Prompt pass that fills ``state`` in place. batch: ``{"tokens": (B,
    S)}`` and the stub inputs the config reads. Returns (last-position
    logits (B, vocab) float32, state ready for decode at pos = S)."""
    params = _view(cfg, params)
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    memory = _memory(cfg, params, batch, force)
    for spec, p, st in zip(layer_specs(cfg), params.layers, state):
        x = _prefill_layer(cfg, spec, p, st, x, positions, memory, force)
    x = _norm(cfg, params.final_norm, _batch_sharded(x))
    return _logits(cfg, params, x[:, -1]), state


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: LMParams, state: list[dict], tokens,
                pos: int, *, force=None) -> tuple[torch.Tensor, list[dict]]:
    """One decode step. tokens: (B, 1); pos: index of the new token (learned
    positions are clamped at the table's last row). Updates ``state`` in
    place; returns (logits (B, vocab) float32, state)."""
    params = _view(cfg, params)
    x = _embed(cfg, params, _tokens(params, tokens))
    pos = int(pos)
    if cfg.learned_pos:
        row = min(pos, params.pos_embed.shape[0] - 1)
        x = x + params.pos_embed[row][None, None].to(x.dtype)
    for spec, p, st in zip(layer_specs(cfg), params.layers, state):
        x = _decode_layer(cfg, spec, p, st, x, pos, force)
    x = _norm(cfg, params.final_norm, _batch_sharded(x))
    return _logits(cfg, params, x[:, 0]), state
