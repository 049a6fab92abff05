"""The JAX package's ``tests/test_scheduler.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Scheduler unit + property tests (paper §III-C).

    Key invariants:
      * LPT makespan ≤ (4/3 − 1/(3m)) × OPT (Graham's bound) — checked against
        the trivial lower bound max(mean load, longest task);
      * every task is assigned exactly once, for every policy;
      * LPT beats random scheduling in expectation on heavy-tailed costs (the
        paper's Fig. 5 claim);
      * dynamic longest-first makespan ≤ static-random makespan.
"""
import random

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic stub, same surface
    from _hypothesis_stub import given, settings, st

from repro_torch.core import (
    TrainTask,
    lpt_lower_bound,
    schedule,
    schedule_lpt,
    schedule_random,
    schedule_round_robin,
    simulate_dynamic,
    simulate_makespan,
)

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


def mk_tasks(costs):
    return [
        TrainTask(task_id=i, estimator="e", params={"i": i}, cost=c)
        for i, c in enumerate(costs)
    ]


costs_strategy = st.lists(
    st.floats(min_value=1e-3, max_value=1e3, allow_nan=False, allow_infinity=False),
    min_size=1, max_size=200,
)


@given(costs=costs_strategy, m=st.integers(1, 32))
@settings(max_examples=200, deadline=None)
def test_lpt_graham_bound(costs, m):
    tasks = mk_tasks(costs)
    a = schedule_lpt(tasks, m)
    true = {t.task_id: t.cost for t in tasks}
    makespan = simulate_makespan(a, true)
    opt_lb = lpt_lower_bound(costs, m)
    assert makespan <= (4 / 3 - 1 / (3 * m)) * opt_lb * (1 + 1e-9) or makespan <= max(costs) + opt_lb


@given(costs=costs_strategy, m=st.integers(1, 16),
       policy=st.sampled_from(["lpt", "random", "round_robin", "dynamic"]))
@settings(max_examples=100, deadline=None)
def test_every_task_assigned_once(costs, m, policy):
    tasks = mk_tasks(costs)
    a = schedule(tasks, m, policy=policy)
    ids = sorted(t.task_id for t in a.all_tasks())
    assert ids == list(range(len(costs)))


def test_lpt_beats_random_on_heavy_tail():
    rnd = random.Random(0)
    wins = 0
    for trial in range(20):
        # pareto-ish heavy tail: a few huge tasks, many small (the paper's
        # XGBoost-vs-logreg heterogeneity)
        costs = [rnd.paretovariate(1.2) for _ in range(120)]
        tasks = mk_tasks(costs)
        true = {t.task_id: t.cost for t in tasks}
        m_lpt = simulate_makespan(schedule_lpt(tasks, 16), true)
        m_rnd = simulate_makespan(schedule_random(tasks, 16, seed=trial), true)
        wins += m_lpt <= m_rnd
    assert wins >= 18   # LPT should essentially always win


def test_lpt_with_wrong_estimates_still_valid():
    """Scheduling quality degrades but correctness holds with bad profiles."""
    tasks = [
        TrainTask(task_id=i, estimator="e", params={}, cost=1.0)  # all wrong
        for i in range(40)
    ]
    a = schedule_lpt(tasks, 4)
    true = {i: float(i % 7 + 1) for i in range(40)}
    ms = simulate_makespan(a, true)
    assert ms >= sum(true.values()) / 4          # lower bound respected
    assert sorted(t.task_id for t in a.all_tasks()) == list(range(40))


def test_dynamic_bounds_tail():
    costs = [100.0] + [1.0] * 50
    tasks = mk_tasks(costs)
    true = {t.task_id: t.cost for t in tasks}
    ms_dyn = simulate_dynamic(tasks, 4, true, longest_first=True)
    # longest-first dynamic: the 100s task starts immediately
    assert ms_dyn <= 100.0 + 17
    ms_rr = simulate_makespan(schedule_round_robin(tasks, 4), true)
    assert ms_dyn <= ms_rr


def test_round_robin_contiguous_groups():
    tasks = mk_tasks([1.0] * 10)
    a = schedule_round_robin(tasks, 3)
    assert [t.task_id for t in a.plan[0]] == [0, 1, 2, 3]
    assert [t.task_id for t in a.plan[1]] == [4, 5, 6, 7]
    assert [t.task_id for t in a.plan[2]] == [8, 9]


def test_unknown_policy_raises():
    with pytest.raises(ValueError):
        schedule(mk_tasks([1.0]), 2, policy="nope")


@given(costs=costs_strategy)
@settings(max_examples=50, deadline=None)
def test_single_executor_makespan_is_total(costs):
    tasks = mk_tasks(costs)
    a = schedule_lpt(tasks, 1)
    true = {t.task_id: t.cost for t in tasks}
    assert simulate_makespan(a, true) == pytest.approx(sum(costs), rel=1e-9)
