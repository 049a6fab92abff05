"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from portbench import manifest

M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WORKLOADS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys_and_valid_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        for e in M[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert want <= set(e) <= want | extra, (section, e)
            assert NAME.match(e["name"]), e["name"]
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    assert len(WORKLOADS) == len(set(WORKLOADS))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    e2e = {m["name"] for m in M["end_to_end"]}
    pairs = set()
    for w in M["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        c = manifest.cell(w["name"])
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e and m["moves"] in reported
    assert len(pairs) == len(M["workloads"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_finds_every_file_by_name(workload):
    c = manifest.cell(workload)
    assert hasattr(manifest.driver(c.traffic["kind"]), "window")
    assert hasattr(manifest.dataset(c.config["dataset"]["kind"]), "make")
    ref = manifest.reference(c.config["estimator"])
    for fn in ("check", "control_fit", "max_bins", "features_scanned"):
        assert callable(getattr(ref, fn))
    assert set(c.limits) >= {"edges_bad", "codes_bad", "unscored", "split_gap",
                             "leaf_err", "auc_gap"}
    for m in c.per_layer + c.end_to_end:
        assert callable(manifest.metric(m["name"]).read)


def test_configs_name_their_files_and_cuts():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_layers_are_named_alike():
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    assert {"search", "executors", "data format", "level loops", "kernels", "device",
            "whole step"} == set(layers)


def test_unknown_workload_names_the_known_ones():
    with pytest.raises(KeyError, match="gbdt-higgs.grid"):
        manifest.cell("no-such.cell")


def test_metrics_limited_to_some_cells_and_metrics_that_follow_what_they_move():
    """An end-to-end metric with ``workloads`` is reported in those cells
    alone; a per-layer metric without the key in every cell that reports
    the metric it moves (the rules a later cell's entries rely on)."""
    m = json.loads(json.dumps(M))
    m["end_to_end"].append({"name": "fit_s", "unit": "s", "better": "lower", "bound": 0.1,
                            "source": "host_clock", "workloads": ["gbdt-higgs.refit"]})
    m["per_layer"].append({"name": "fit_host_share", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "level loops", "moves": "fit_s"})
    refit = manifest.cell("gbdt-higgs.refit", m)
    grid = manifest.cell("gbdt-higgs.grid", m)
    assert "fit_s" in [e["name"] for e in refit.end_to_end]
    assert "fit_s" not in [e["name"] for e in grid.end_to_end]
    assert "fit_host_share" in [p["name"] for p in refit.per_layer]
    assert "fit_host_share" not in [p["name"] for p in grid.per_layer]
