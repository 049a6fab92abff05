"""The JAX package's ``tests/test_registry.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    register_estimator accepts classes, factories, and instances (paper §III-B:
    plugging in a new ML implementation is registry glue, nothing more).
"""
import numpy as np
import pytest

from repro_torch.core import (
    Estimator,
    TrainedModel,
    get_estimator,
    register_estimator,
    unregister_estimator,
)

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


class _Model(TrainedModel):
    def predict_proba(self, x):
        return np.zeros(x.shape[0], dtype=np.float32)


def _mk_estimator_cls(cls_name):
    class _Est(Estimator):
        name = cls_name

        def train(self, data, params):
            return _Model()

    _Est.__name__ = cls_name
    return _Est


@pytest.fixture
def clean_registry():
    names = []
    yield names
    for n in names:
        unregister_estimator(n)


def test_register_class_instantiates_fresh(clean_registry):
    cls = _mk_estimator_cls("reg_cls")
    assert register_estimator(cls) is cls       # decorator-transparent
    clean_registry.append("reg_cls")
    a, b = get_estimator("reg_cls"), get_estimator("reg_cls")
    assert isinstance(a, cls) and isinstance(b, cls)
    assert a is not b                           # new instance per lookup


def test_register_factory_called_per_lookup(clean_registry):
    cls = _mk_estimator_cls("reg_factory")
    calls = []

    def factory():
        calls.append(1)
        return cls()

    register_estimator(factory)
    clean_registry.append("reg_factory")
    get_estimator("reg_factory")
    get_estimator("reg_factory")
    assert len(calls) == 3                      # 1 probe + 2 lookups


def test_register_instance_returns_same_object(clean_registry):
    inst = _mk_estimator_cls("reg_inst")()
    assert register_estimator(inst) is inst
    clean_registry.append("reg_inst")
    assert get_estimator("reg_inst") is inst
    assert get_estimator("reg_inst") is inst


def test_register_rejects_bad_inputs(clean_registry):
    with pytest.raises(TypeError):
        register_estimator(object())            # not class/factory/instance
    with pytest.raises(TypeError):
        register_estimator(dict)                # class, but not an Estimator
    with pytest.raises(TypeError):
        register_estimator(lambda: object())    # factory of non-Estimator

    class NoName(Estimator):
        def train(self, data, params):
            return _Model()

    with pytest.raises(ValueError):
        register_estimator(NoName)              # empty .name

    cls = _mk_estimator_cls("reg_dup")
    register_estimator(cls)
    clean_registry.append("reg_dup")
    with pytest.raises(ValueError):
        register_estimator(cls)                 # duplicate name


def test_unregister_allows_reregistration(clean_registry):
    cls = _mk_estimator_cls("reg_cycle")
    register_estimator(cls)
    unregister_estimator("reg_cycle")
    register_estimator(cls)                     # no duplicate error
    clean_registry.append("reg_cycle")
    assert isinstance(get_estimator("reg_cycle"), cls)
