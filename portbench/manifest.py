"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives it; the traffic mix
is ``traffic/<traffic>.json``; its ``kind`` names the driver
``drivers/<kind>.py``; the configuration's ``dataset.kind`` names the
generator ``datasets/<kind>.py``, its ``estimator`` the plain reference
``reference/<estimator>.py``; each metric is read by
``metrics/<name>.py``; the limits of the comparison that decides
``correct`` are ``limits/<cell>.json``. Adding a cell, a metric or a
configuration adds files and entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file, with its ``name``
    traffic: dict           # the traffic file, with its ``name``
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list
    limits: dict            # name -> limit of each number compared


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """A per-layer metric is read in the cells its ``workloads`` lists, or,
    without the key, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with every file it names read."""
    manifest = manifest if manifest is not None else load_manifest(root)
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in manifest["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    w = found[0]
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    config["name"] = cfg_entry["name"]
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["name"] = w["traffic"]
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, e2e_names)]
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, limits=limits)


def _module(kind: str, name: str) -> ModuleType:
    full = f"portbench.{kind}.{name}"
    if full in sys.modules:
        return sys.modules[full]
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    return mod


def driver(kind: str) -> ModuleType:
    """``drivers/<kind>.py``: ``setup(cell, inputs, device)`` and
    ``window(state, seconds)``."""
    return _module("drivers", kind)


def dataset(kind: str) -> ModuleType:
    """``datasets/<kind>.py``: ``make(spec, seed, device) -> Inputs``."""
    return _module("datasets", kind)


def reference(estimator: str) -> ModuleType:
    """``reference/<estimator>.py``: the plain fit the comparison checks."""
    return _module("reference", estimator)


def metric(name: str) -> ModuleType:
    """``metrics/<name>.py``: ``read(ctx) -> float | None``."""
    return _module("metrics", name)


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())
