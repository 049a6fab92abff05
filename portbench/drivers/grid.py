"""Traffic kind ``grid``: the configuration's grid searched back to back.

Closed loop: one client runs ``Session(SearchSpec(...)).results(train,
valid)`` — the path ``launch/search.py::run_tabular`` takes — with the
traffic file's executors, policy and sampling profiler, and starts the same
search again as soon as one ends, until the window closes. Every search
profiles its configurations on a row sample (the paper's §III-C), schedules
them and trains and scores them on the executor threads. A fit counts when
its result arrives inside the window; at the close the search is cancelled
(the executors finish the fit in hand, which is not counted).

Set-up fills the prepared-data cache with every format of the grid and the
validation rows (repeated searches over one dataset hit it, as users' do)
and fits each (format, depth) of the grid for one round, scored.
"""
from __future__ import annotations

import dataclasses
import time

from portbench import manifest
from portbench.window import Fit, Window


@dataclasses.dataclass
class State:
    spec: object
    train: object
    valid: object
    n_executors: int
    convert_s: float
    payloads: dict          # the reference's max_bins -> the prepared payload


def _estimator_spaces(config):
    from repro_torch.core import GridBuilder

    b = GridBuilder(config["estimator"])
    for k, v in config["grid"].items():
        b.add_grid(k, v)
    space = b.build()
    fixed = config.get("fixed", {})
    return type(space)(space.estimator, tuple({**fixed, **c} for c in space.configs))


def setup(cell, inputs, device) -> State:
    from repro_torch.core import (DenseMatrix, EvalPlan, SamplingProfiler, SearchSpec,
                                  get_estimator, prepare_cached)
    from repro_torch.core.evaluation import evaluate_models

    cfg, tr = cell.config, cell.traffic
    train = DenseMatrix(inputs.x_train, inputs.y_train)
    valid = DenseMatrix(inputs.x_valid, inputs.y_valid)
    space = _estimator_spaces(cfg)
    est = get_estimator(space.estimator)
    ref = manifest.reference(space.estimator)
    convert_s, payloads, warm = 0.0, {}, {}
    for c in space.configs:
        mb = ref.max_bins(c)
        if mb not in payloads:
            payloads[mb], secs, _ = prepare_cached(train, est.data_format, est.format_params(c))
            convert_s += secs
        warm.setdefault((mb, c.get("max_depth")), c)
    prepare_cached(valid, est.eval_format)
    plan = EvalPlan(valid, "auc")
    for (mb, _), c in warm.items():
        model = est.train(payloads[mb], {**c, est.budget_param: 1})
        evaluate_models(est, [model], plan)
    spec = SearchSpec(spaces=[space], n_executors=int(tr["executors"]), policy=tr["policy"],
                      profiler=SamplingProfiler(float(tr["sample_rate"])), metric="auc", seed=0)
    return State(spec=spec, train=train, valid=valid, n_executors=int(tr["executors"]),
                 convert_s=convert_s, payloads=payloads)


def window(state: State, seconds: float, clock=time.perf_counter) -> Window:
    from repro_torch.core import Session, get_estimator

    t_begin = clock()
    t_end = t_begin + seconds
    fits, searches = [], []
    while clock() < t_end:
        session = Session(state.spec)
        stream = session.results(state.train, state.valid)
        try:
            for r in stream:
                now = clock()
                if now > t_end:
                    break
                est = get_estimator(r.task.estimator)
                fits.append(Fit(params=dict(r.task.params),
                                trees=int(r.task.params[est.budget_param]), arrived=now,
                                train_s=r.train_seconds, eval_s=r.eval_seconds,
                                ok=r.ok and r.score is not None, score=r.score,
                                model=r.model,
                                trained=(now - r.eval_seconds - r.train_seconds,
                                         now - r.eval_seconds)))
        finally:
            stream.close()
        searches.append(session.stats)
    return Window(t_begin=t_begin, t_end=t_end, fits=fits, n_executors=state.n_executors,
                  searches=searches)
