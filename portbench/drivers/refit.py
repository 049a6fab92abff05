"""Traffic kind ``refit``: one configuration fitted back to back.

Closed loop through the estimator interface alone: ``get_estimator(...)
.train`` on the prepared payload, then the executors' scorer
(``core/evaluation.py::evaluate_models``) on the validation rows, again as
soon as the last one is scored, until the window closes. This is the fit a
user makes of the chosen model; it bypasses the session, the scheduler,
the profiler and the executor threads. The configuration's ``fixed``
hyperparameters with the traffic file's ``params`` over them.
"""
from __future__ import annotations

import dataclasses
import time

from portbench import manifest
from portbench.window import Fit, Window


@dataclasses.dataclass
class State:
    est: object
    params: dict
    payload: object
    plan: object
    convert_s: float
    payloads: dict          # the reference's max_bins -> the prepared payload


def setup(cell, inputs, device) -> State:
    from repro_torch.core import DenseMatrix, EvalPlan, get_estimator, prepare_cached
    from repro_torch.core.evaluation import evaluate_models

    cfg = cell.config
    est = get_estimator(cfg["estimator"])
    params = {**cfg.get("fixed", {}), **cell.traffic["params"]}
    train = DenseMatrix(inputs.x_train, inputs.y_train)
    valid = DenseMatrix(inputs.x_valid, inputs.y_valid)
    fp = est.format_params(params)
    payload, convert_s, _ = prepare_cached(train, est.data_format, fp)
    prepare_cached(valid, est.eval_format)
    plan = EvalPlan(valid, "auc")
    evaluate_models(est, [est.train(payload, {**params, est.budget_param: 1})], plan)
    mb = manifest.reference(est.name).max_bins(params)
    return State(est=est, params=params, payload=payload, plan=plan, convert_s=convert_s,
                 payloads={mb: payload})


def window(state: State, seconds: float, clock=time.perf_counter) -> Window:
    from repro_torch.core.evaluation import evaluate_models

    est, params = state.est, state.params
    t_begin = clock()
    t_end = t_begin + seconds
    fits = []
    while clock() < t_end:
        t0 = clock()
        model = est.train(state.payload, params)
        t1 = clock()
        scores, eval_s = evaluate_models(est, [model], state.plan)
        now = clock()
        if now > t_end:
            break
        fits.append(Fit(params=dict(params),
                        trees=int(params[est.budget_param]), arrived=now,
                        train_s=t1 - t0, eval_s=eval_s, ok=scores[0] is not None,
                        score=scores[0], model=model, trained=(t0, t1)))
    return Window(t_begin=t_begin, t_end=t_end, fits=fits, n_executors=1)
