"""The plain reference against the port on the CPU at small sizes, its
independence from the program, and the no-JAX check."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, manifest
from portbench.reference import auc, bins
from portbench.tests import tiny


@pytest.mark.parametrize("max_bins", [16, 256])
def test_bins_are_the_programs_bit_for_bit(max_bins):
    from repro_torch.core.data_format import DenseMatrix, convert

    inputs = manifest.dataset("higgs_like").make({"rows": 2500}, 11, "cpu")
    got = convert(DenseMatrix(inputs.x_train, inputs.y_train), "quantized_bins",
                  max_bins=max_bins, device="cpu")
    edges, codes = bins.quantize(torch.from_numpy(inputs.x_train), max_bins)
    assert torch.equal(got["edges"], edges.to(torch.float32))
    assert torch.equal(got["bins"], codes)


def test_auc_is_the_rank_statistic_with_ties():
    from repro_torch.core.results import auc as program_auc

    rng = np.random.default_rng(3)
    y = (rng.random(500) < 0.4).astype(np.float32)
    s = np.round(rng.normal(size=500) + y, 1)        # many ties
    assert abs(auc.auc(torch.from_numpy(y), torch.from_numpy(s))
               - program_auc(y, s)) < 1e-12


def test_data_is_the_seeds():
    a = manifest.dataset("higgs_like").make({"rows": 1000}, 2**31 + 5, "cpu")
    b = manifest.dataset("higgs_like").make({"rows": 1000}, 2**31 + 5, "cpu")
    c = manifest.dataset("higgs_like").make({"rows": 1000}, 2**31 + 6, "cpu")
    assert np.array_equal(a.x_train, b.x_train) and np.array_equal(a.y_valid, b.y_valid)
    assert not np.array_equal(a.x_train, c.x_train)
    assert a.x_train.shape == (600, 28) and a.x_valid.shape == (200, 28)
    assert abs(a.y_train.mean() - 0.5) < 0.1


@pytest.mark.parametrize("workload", ["gbdt-higgs.refit", "gbdt-higgs.grid",
                                      "forest-higgs.grid"])
def test_a_sound_run_of_the_port_is_correct(workload):
    r = tiny.run(workload)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["trees_per_s"]["value"] > 0
    c = r["compared"]
    assert c["edges_bad"]["value"] == c["codes_bad"]["value"] == 0
    assert c["checked"]["value"] >= 1


@pytest.mark.parametrize("estimator", ["gbdt", "forest"])
def test_the_control_in_bfloat16_is_not_correct(estimator):
    """The reference put in the program's place in bfloat16 fails the limits
    of a tiny cell, as it does at the cells' size on the card."""
    from portbench import control

    workload = "gbdt-higgs.refit" if estimator == "gbdt" else "forest-higgs.grid"
    readings = control.readings(tiny.cell(workload), 7, "cpu")
    assert readings["correct"] is False, readings
    limits = manifest.cell(workload).limits
    assert readings["compared"]["split_gap"]["limit"] == limits["split_gap"]
    assert any(readings[k] > limits[k] for k in ("split_gap", "leaf_err", "auc_gap")), readings


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.core", "reproduce", "jaxtyping", "repro",
            "repro.core", "jax.numpy", "jaxlib", "flax.linen", "numpy"]
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                               "repro", "repro.core"]


def test_a_run_loads_no_jax_and_the_reference_loads_no_program():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import portbench.reference.gbdt, portbench.reference.forest, portbench.check\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch'], 'program'\n"
        "from portbench.tests import tiny\n"
        "tiny.run('gbdt-higgs.refit')\n"
        "from portbench import harness\n"
        "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok"]


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gbdt-higgs.refit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
