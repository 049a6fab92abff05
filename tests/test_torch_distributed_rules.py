"""The port's partition rules against the JAX package's, on the CPU.

For the smoke AND the full config of all ten architectures, the same
parameter, optimizer-state and decode-state trees (the port's shapes on
the ``meta`` device, the JAX package's from ``jax.eval_shape``; the trees'
paths are the same) go through both packages' rules: ``param_pspecs``
(FSDP on and off), ``state_pspecs`` at every ``SHAPES`` entry and several
(dp, tp) sizes and sequence-sharding modes, ``zero1_pspecs``,
``opt_pspecs`` (AdamW, SGD-momentum, Adafactor), ``make_train_state_specs``
and ``logical_to_mesh`` on the multi-pod axis map. Every spec equals the
reference's leaf for leaf, as tuples. ``bytes_per_device`` equals the
reference's on the same trees and mesh sizes. Nothing here needs a
process group.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.train import make_optimizer as jmake_optimizer  # noqa: E402
from repro.train.train_step import make_train_state_specs as jmake_specs  # noqa: E402
from repro.train.train_step import opt_pspecs as jopt_pspecs  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.train import make_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_state_specs, opt_pspecs  # noqa: E402

ARCHS = configs.ARCH_IDS
SIZES = ("smoke", "full")
POD_MAP = {"dp": ("pod", "data"), "tp": "model"}
# (dp, tp) sizes the decode-state rules are held at: one device, a small
# test mesh, the production meshes (one pod, two pods) and sizes that do not
# divide some dims
STATE_SIZES = ((1, 1), (2, 4), (32, 8), (64, 8), (3, 5), (4, 16))


def _cfg(pkg, arch, size):
    return pkg.get_smoke_config(arch) if size == "smoke" else pkg.get_config(arch)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch, size):
    jcfg, cfg = _cfg(jconfigs, arch, size), _cfg(configs, arch, size)
    jshapes = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    shapes = models.params_to_reference(cfg, models.init_params(cfg, device="meta"))
    return jshapes, shapes


def _is_jspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _flat(tree, is_leaf, prefix=""):
    """{path: leaf} of a nested dict (lists by position)."""
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, is_leaf, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, is_leaf, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _same_specs(mine, ref):
    got = {k: tuple(v) for k, v in _flat(mine, lambda x: isinstance(x, shd.P)).items()}
    want = {k: tuple(v) for k, v in _flat(ref, _is_jspec).items()}
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]
    return len(got)


def _same_shapes(mine, ref):
    got = {k: tuple(v.shape) for k, v in _flat(mine, lambda x: hasattr(x, "shape")).items()}
    want = {k: tuple(v.shape) for k, v in _flat(ref, lambda x: hasattr(x, "shape")).items()}
    assert got == want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_pspecs_equal_the_reference(arch, size, fsdp):
    jshapes, shapes = _param_shapes(arch, size)
    _same_shapes(shapes, jshapes)
    n = _same_specs(shd.param_pspecs(shapes, fsdp=fsdp), jshd.param_pspecs(jshapes, fsdp=fsdp))
    assert n == len(jax.tree.leaves(jshapes))
    # on the multi-pod map too
    _same_specs(shd.logical_to_mesh(shd.param_pspecs(shapes, fsdp=fsdp), POD_MAP),
                jshd.logical_to_mesh(jshd.param_pspecs(jshapes, fsdp=fsdp), POD_MAP))


def _stacked_state(cfg, state: list) -> dict:
    """The port's per-layer decode state in the JAX package's layout
    (``blocks/b{j}`` stacked over the repeats, then ``tail{j}``)."""
    n_pat, n_stacked = len(cfg.pattern), len(cfg.pattern) * cfg.repeats

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}

    tree = {"blocks": {f"b{j}": stack(state[j:n_stacked:n_pat]) for j in range(n_pat)}}
    for j in range(len(cfg.tail)):
        tree[f"tail{j}"] = state[n_stacked + j]
    return tree


@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_pspecs_equal_the_reference(arch, size, shape):
    cell = configs.SHAPES[shape]
    assert dataclasses.astuple(cell) == dataclasses.astuple(jconfigs.SHAPES[shape])
    jcfg, cfg = _cfg(jconfigs, arch, size), _cfg(configs, arch, size)
    b, s = cell.global_batch, cell.seq_len
    jstate = jax.eval_shape(lambda: jmodels.init_decode_state(jcfg, b, s, jnp.bfloat16))
    state = models.init_decode_state(cfg, b, s, torch.bfloat16, device="meta")
    stacked = _stacked_state(cfg, state)
    _same_shapes(stacked, jstate)
    for dp, tp in STATE_SIZES:
        for seq_shard in (False, True, "full"):
            kw = dict(seq_shard=seq_shard, dp_size=dp, tp_size=tp)
            ref = jshd.state_pspecs(jstate, **kw)
            _same_specs(shd.state_pspecs(stacked, **kw), ref)
            _same_specs(shd.logical_to_mesh(shd.state_pspecs(stacked, **kw), POD_MAP),
                        jshd.logical_to_mesh(ref, POD_MAP))
            # the port's own per-layer list: each layer the reference's
            # inner spec (its stacked leaves without the repeats dim)
            per_layer = shd.state_pspecs(state, **kw)
            n_pat, n_stacked = len(cfg.pattern), len(cfg.pattern) * cfg.repeats
            for i, layer in enumerate(per_layer):
                if i < n_stacked:
                    want = _flat(ref["blocks"][f"b{i % n_pat}"], _is_jspec)
                    want = {k: tuple(v)[1:] for k, v in want.items()}
                else:
                    want = {k: tuple(v) for k, v in
                            _flat(ref[f"tail{i - n_stacked}"], _is_jspec).items()}
                got = {k: tuple(v) for k, v in
                       _flat(layer, lambda x: isinstance(x, shd.P)).items()}
                assert got == want, (i, kw)


@pytest.mark.parametrize("opt", ["adamw", "sgdm", "adafactor"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_and_train_state_specs_equal_the_reference(arch, size, opt):
    jshapes, shapes = _param_shapes(arch, size)
    jcfg, cfg = _cfg(jconfigs, arch, size), _cfg(configs, arch, size)
    for fsdp in (False, True):
        p, jp = shd.param_pspecs(shapes, fsdp=fsdp), jshd.param_pspecs(jshapes, fsdp=fsdp)
        o, jo = opt_pspecs(opt, p, shapes), jopt_pspecs(opt, jp, jshapes)
        _same_specs(o, jo)
        opt_shapes = make_optimizer(opt).init(shapes)
        jopt_shapes = jax.eval_shape(jmake_optimizer(opt).init, jshapes)
        _same_shapes(opt_shapes, jopt_shapes)
        for data_size in (1, 2, 32, 64):
            _same_specs(shd.zero1_pspecs(o, opt_shapes, data_size),
                        jshd.zero1_pspecs(jo, jopt_shapes, data_size))
    for fsdp, zero1, data_size in ((False, True, 2), (True, True, 32), (True, False, 64)):
        shapes_s, specs = make_train_state_specs(cfg, make_optimizer(opt), fsdp=fsdp,
                                                 zero1=zero1, data_size=data_size)
        jshapes_s, jspecs = jmake_specs(jcfg, jmake_optimizer(opt), fsdp=fsdp, zero1=zero1,
                                        data_size=data_size)
        _same_shapes(shapes_s, jshapes_s)
        assert set(specs) == set(jspecs) == {"step", "params", "opt_state"}
        _same_specs(specs, jspecs)
        _same_specs(shd.logical_to_mesh(specs, POD_MAP), jshd.logical_to_mesh(jspecs, POD_MAP))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_per_device_equals_the_reference(arch, size):
    jshapes, shapes = _param_shapes(arch, size)
    for fsdp in (False, True):
        p, jp = shd.param_pspecs(shapes, fsdp=fsdp), jshd.param_pspecs(jshapes, fsdp=fsdp)
        for sizes in ({"data": 1, "model": 1}, {"data": 2, "model": 4},
                      {"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8}):
            axis_map = jshd.infer_axis_map(type("M", (), {"axis_names": tuple(sizes)})())
            assert shd.infer_axis_map(sizes) == axis_map
            got = shd.bytes_per_device(shapes, p, sizes, axis_map)
            assert got == jshd.bytes_per_device(jshapes, jp, sizes, axis_map)
            assert got >= sum(v.numel() * v.element_size() for v in shd.tree_leaves(
                shapes, is_leaf=lambda x: False)) // (sizes.get("pod", 1) * sizes["data"]
                                                      * sizes["model"])


def test_the_reference_small_cases():
    """The JAX package's own rule tests (tests/test_distributed.py) on the
    port's rules."""
    P = shd.P
    shapes = {"embed": torch.empty(1024, 64, device="meta"),
              "blocks": {"b0": {"ffn": {"w_gate": torch.empty(2, 64, 256, device="meta"),
                                        "w_down": torch.empty(2, 256, 64, device="meta")}}}}
    specs = shd.param_pspecs(shapes, fsdp=False)
    assert specs["embed"] == P("tp", None)
    assert specs["blocks"]["b0"]["ffn"]["w_gate"] == P(None, None, "tp")
    assert specs["blocks"]["b0"]["ffn"]["w_down"] == P(None, "tp", None)
    z = shd.zero1_pspecs({"w": P(None, "tp")}, {"w": torch.empty(64, 512, device="meta")}, 16)
    assert z["w"] == P("dp", "tp")
    assert shd.zero1_pspecs({"w": P(None, None)}, {"w": torch.empty(7, 13, device="meta")},
                            16)["w"] == P(None, None)
    o = opt_pspecs("adafactor", {"w": P("dp", "tp"), "b": P("tp")},
                   {"w": torch.empty(64, 512, device="meta"), "b": torch.empty(512)})
    assert (o["w"]["row"], o["w"]["col"], o["b"]["v"]) == (P("dp"), P("tp"), P("tp"))
    mapped = shd.logical_to_mesh({"x": P("dp", "tp"), "y": P(("dp", "tp"))}, POD_MAP)
    assert mapped["x"] == P(("pod", "data"), "model")
    assert mapped["y"] == P(("pod", "data", "model"))
    kv = {"blocks": {"b0": {"kv": {"k": torch.empty(2, 1, 3, 64, 16, device="meta"),
                                   "v": torch.empty(2, 1, 3, 64, 16, device="meta")}}}}
    assert shd.state_pspecs(kv, dp_size=1, tp_size=4)["blocks"]["b0"]["kv"]["k"] == \
        P(None, None, None, "tp", None)
    assert shd.state_pspecs(kv, dp_size=4, tp_size=4)["blocks"]["b0"]["kv"]["k"][1] is None
    _, specs = make_train_state_specs(configs.get_smoke_config("qwen3_moe_235b"),
                                      make_optimizer("adafactor"), fsdp=True, zero1=True,
                                      data_size=2)
    assert specs["params"]["blocks"]["b0"]["moe"]["w_gate"] == P(None, "tp", "dp", None)
