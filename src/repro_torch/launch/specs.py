"""Abstract input stand-ins for every (arch × shape) cell, and the cell's
step on a mesh.

The port of the JAX package's ``launch/specs.py``. ``input_specs`` returns
tensors that hold shapes and dtypes only: ``meta`` tensors, or, inside a
``FakeTensorMode`` (the dry-run's), fake tensors on the card's device type;
nothing is allocated either way. ``build_cell`` assembles the cell's step
(``train_step`` / ``prefill`` / ``decode_step``) with its arguments placed
on the mesh as DTensors (params and optimizer state per the partition
rules, the batch over dp, the decode state per ``state_pspecs``) and the
placement trees, the counterparts of the reference's in/out shardings.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.models import decode_step, init_decode_state, init_params, prefill, \
    params_to_reference
from repro_torch.models.transformer import ArchConfig
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import build_train_step, data_size_of, distribute_tree, \
    make_train_state_specs

__all__ = ["cell_config", "input_specs", "build_cell", "Cell", "FSDP_ARCHS", "ADAFACTOR_ARCHS"]

# param/optimizer memory is the binding constraint on these — shard params
# over data too (ZeRO-3 / FSDP) and use factored optimizer state
FSDP_ARCHS = {"qwen3_moe_235b", "arctic_480b", "gemma3_12b", "recurrentgemma_9b", "rwkv6_7b"}
ADAFACTOR_ARCHS = {"qwen3_moe_235b", "arctic_480b"}


def _shape(shape_name) -> configs.ShapeCell:
    """A ``SHAPES`` entry by name, or a ``ShapeCell`` as it is."""
    return configs.SHAPES[shape_name] if isinstance(shape_name, str) else shape_name


def cell_config(arch: str, shape_name) -> ArchConfig:
    """Arch config adjusted for the shape (whisper learned-pos table growth).
    ``shape_name``: a ``SHAPES`` name, or a ``ShapeCell``."""
    arch = configs.resolve(arch)
    cfg = configs.get_config(arch)
    shape = _shape(shape_name)
    if cfg.learned_pos and cfg.max_position < shape.seq_len:
        cfg = dataclasses.replace(cfg, max_position=shape.seq_len)
    return cfg


def input_specs(arch: str, shape_name, device="meta") -> dict[str, Any]:
    """Abstract model inputs for the cell (tokens/labels/stub frontends),
    as empty tensors on ``device`` (``meta``, or a device type under a
    ``FakeTensorMode``)."""
    cfg = cell_config(arch, shape_name)
    shape = _shape(shape_name)
    b, s = shape.global_batch, shape.seq_len

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "train":
        specs = {"tokens": empty((b, s), torch.int32), "labels": empty((b, s), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": empty((b, s), torch.int32)}
    else:  # decode: one new token against an S-long cache
        specs = {"tokens": empty((b, 1), torch.int32)}
    if cfg.frontend == "audio_stub" and shape.kind != "decode":
        specs["enc_embeds"] = empty((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        specs["patch_embeds"] = empty((b, cfg.num_patches, cfg.d_model), torch.bfloat16)
    return specs


@dataclasses.dataclass
class Cell:
    arch: str
    shape_name: Any
    cfg: ArchConfig
    kind: str
    step_fn: Any                 # callable on ``args``
    args: tuple                  # the arguments, placed on the mesh
    in_shardings: tuple          # their placement trees
    out_shardings: Any


def _empty_params(cfg: ArchConfig, device) -> dict:
    """The JAX package's parameter tree of ``cfg`` as empty tensors on
    ``device``: shapes and dtypes, no draws."""
    from repro_torch.train.optimizer import tree_map

    meta = params_to_reference(cfg, init_params(cfg, device="meta"))
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), meta)


def build_cell(arch: str, shape_name, mesh, *, optimizer: str | None = None,
               fsdp: bool | None = None, seq_shard_kv: bool | str | None = None,
               remat: str | None = None, zero1: bool = True, cache_dtype: str = "bfloat16",
               extra_cfg: dict | None = None, device: str = "cuda", force="ref") -> Cell:
    """Assemble a cell's step and its arguments on ``mesh`` (``shape_name``:
    a ``SHAPES`` name or a ``ShapeCell``). The arguments
    are made on ``device`` (call it under a ``FakeTensorMode`` to allocate
    nothing); ``force`` is threaded to ``ops`` (``"ref"``: the kernels'
    plain versions, which a trace can run). ``remat`` (``"full"`` or
    ``"dots"``) recomputes each layer in the backward."""
    arch = configs.resolve(arch)
    cfg = cell_config(arch, shape_name)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    shape = _shape(shape_name)
    if fsdp is None:
        fsdp = arch in FSDP_ARCHS
    if optimizer is None:
        optimizer = "adafactor" if arch in ADAFACTOR_ARCHS else "adamw"
    names = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data_size, tp_size = data_size_of(mesh), names["model"]
    inputs = input_specs(arch, shape_name, device)
    b_specs = shd.batch_pspecs(inputs, data_size)
    batch = distribute_tree(inputs, mesh, b_specs)
    b_sh = shd.named_shardings(mesh, b_specs)

    if shape.kind == "train":
        opt = make_optimizer(optimizer)
        _, state_specs = make_train_state_specs(cfg, opt, fsdp=fsdp, zero1=zero1,
                                                data_size=data_size)
        params = _empty_params(cfg, device)
        state = {"step": 0, "params": distribute_tree(params, mesh, state_specs["params"]),
                 "opt_state": distribute_tree(opt.init(params), mesh, state_specs["opt_state"])}
        del params
        st_sh = shd.named_shardings(mesh, {k: state_specs[k] for k in ("params", "opt_state")})
        step_fn = build_train_step(cfg, opt, mesh=mesh, force=force, state_specs=state_specs,
                                   remat=remat)
        return Cell(arch, shape_name, cfg, "train", step_fn, (state, batch), (st_sh, b_sh),
                    (st_sh, None))

    # inference paths need params + decode state
    params = _empty_params(cfg, device)
    p_specs = shd.param_pspecs(params, fsdp=False)
    params = distribute_tree(params, mesh, p_specs)
    p_sh = shd.named_shardings(mesh, p_specs)
    # sequence-shard the KV cache when kv heads can't fill the tp axis
    # (flash-decoding); batch-1 long-context also spreads seq over dp
    if seq_shard_kv is None:
        if shape.kind == "decode" and shape.global_batch < data_size:
            seq_shard_kv = "full"
        elif shape.kind == "decode" and cfg.n_kv_heads < tp_size:
            seq_shard_kv = True
        else:
            seq_shard_kv = False
    state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                              getattr(torch, cache_dtype), device)
    s_specs = shd.state_pspecs(state, seq_shard=seq_shard_kv, dp_size=data_size,
                               tp_size=tp_size)
    state = distribute_tree(state, mesh, s_specs)
    s_sh = shd.named_shardings(mesh, s_specs)

    if shape.kind == "prefill":
        def step_fn(params, state, batch):
            return _on_mesh(prefill, cfg, params, state, batch, force=force)

        return Cell(arch, shape_name, cfg, "prefill", step_fn, (params, state, batch),
                    (p_sh, s_sh, b_sh), (None, s_sh))

    def step_fn(params, state, tokens, pos):
        return _on_mesh(decode_step, cfg, params, state, tokens, pos, force=force)

    return Cell(arch, shape_name, cfg, "decode", step_fn,
                (params, state, batch["tokens"], shape.seq_len - 1),
                (p_sh, s_sh, b_sh["tokens"], None), (None, s_sh))


def _on_mesh(fn, *args, **kw):
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        return fn(*args, **kw)
