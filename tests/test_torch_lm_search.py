"""The LM search on mesh slices (``launch/search.py --workload lm``,
``run_lm``) and the two LM examples, on the CPU, against the JAX package.

* One process, ``--device cpu --slices 2 --steps 2``: the reference's six
  tasks (qwen2, tinyllama, gemma × lr {1e-3, 3e-3}), their analytic costs
  (the reference's ``count_params(cfg)`` × steps), the LPT assignment to
  slices and the printed estimated makespan equal the JAX package's, built
  in this process from ``repro.core.schedule``; every task is ok, and its
  loss is bit-equal to a one-device ``Trainer`` of the same config and lr.
* The parameter count on the ``meta`` device equals the reference's
  ``count_params`` for all ten smoke configs.
* Four gloo ranks under ``torchrun``'s environment (``launch.mesh.
  run_local_ranks``, child processes, with a timeout), ``--slices 2
  --model-par 2``: the same tasks on the same slices; rank 0 alone prints.
  In the smoke configs' bf16 compute and in float32 compute every loss is
  within 1e-5 relative of the one-process run's: the tensor-parallel and
  data-parallel sums are reduced in float32 before the one rounding, as one
  device and the JAX package do. ``--policy dynamic`` raises under ranks
  and runs in one process; ``--model-par 2`` in one process raises, naming
  torchrun.
* ``MeshSliceExecutorPool`` on the process mesh: a slice lost to
  ``ExecutorFailure`` ends its own queue with error results, the same on
  every rank.
* ``repro_torch.examples.distributed_search`` and ``.serve_lm`` run with
  ``--device cpu``, and the first on the 4 ranks too.
"""
import contextlib
import dataclasses
import io
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.core import GridBuilder as RefGridBuilder  # noqa: E402
from repro.core import TrainTask as RefTrainTask  # noqa: E402
from repro.core import schedule as ref_schedule  # noqa: E402
from repro.models import count_params as ref_count_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import make_lm_stream  # noqa: E402
from repro_torch.launch import search  # noqa: E402
from repro_torch.launch.mesh import run_local_ranks  # noqa: E402
from repro_torch.models import count_params, init_params  # noqa: E402
from repro_torch.train import Trainer, make_optimizer  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
TIMEOUT = 120
STEPS = 2
ARGV = ["--workload", "lm", "--device", "cpu", "--slices", "2", "--steps", str(STEPS)]
RTOL = 1e-5          # ranks against one process: float32 sums in another order


def _reference_plan(steps: int):
    """The JAX package's ``run_lm`` tasks and assignment, without a mesh."""
    tasks = []
    for arch in ["qwen2_1_5b", "tinyllama_1_1b", "gemma_2b"]:
        for cfg_params in RefGridBuilder(arch).add_grid("lr", [1e-3, 3e-3]).build().configs:
            tasks.append(RefTrainTask(task_id=len(tasks), estimator=arch,
                                      params=dict(cfg_params)))
    tasks = [t.with_cost(ref_count_params(ref_configs.get_smoke_config(t.estimator)) * steps)
             for t in tasks]
    return tasks, ref_schedule(tasks, 2, policy="lpt")


def _run(argv) -> tuple[list, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = search.run_lm(search.parse_args(argv))
    return results, buf.getvalue()


def _f32_configs(monkeypatch):
    get = configs.get_smoke_config
    monkeypatch.setattr(configs, "get_smoke_config",
                        lambda a: dataclasses.replace(get(a), compute_dtype="float32"))


@pytest.fixture(scope="module")
def one_process():
    return _run(ARGV)


@pytest.fixture(scope="module")
def one_process_f32():
    with pytest.MonkeyPatch.context() as mp:
        _f32_configs(mp)
        return _run(ARGV)


_RANKS = """
import dataclasses, json
import torch.distributed as dist
from repro_torch import configs
from repro_torch.launch import search

argv = {argv!r} + ["--model-par", "2"]
runs = {{"bf16": search.run_lm(search.parse_args(argv))}}
get = configs.get_smoke_config
configs.get_smoke_config = lambda a: dataclasses.replace(get(a), compute_dtype="float32")
runs["f32"] = search.run_lm(search.parse_args(argv))
configs.get_smoke_config = get
try:
    search.run_lm(search.parse_args(argv + ["--policy", "dynamic"]))
    dynamic = None
except ValueError as e:
    dynamic = str(e)

# the pool on the process mesh directly: slice 1 is lost at its second task
from repro_torch.core import ExecutorFailure, MeshSliceExecutorPool, TrainTask, schedule
from repro_torch.launch.mesh import make_test_mesh
def hook(eid, task):
    if eid == 1 and task.task_id == lost_at:
        raise ExecutorFailure("injected")
tasks = [TrainTask(task_id=i, estimator="x", params={{}}, cost=float(6 - i)) for i in range(6)]
assignment = schedule(tasks, 2, policy="lpt")
lost_at = assignment.plan[1][1].task_id
pool = MeshSliceExecutorPool(make_test_mesh(2, 2, device="cpu"), 2,
                             lambda t, sl, _d: (float(t.task_id), 0.0), failure_hook=hook)
lost = [[r.task.task_id, r.executor_id, r.ok, r.model] for r in pool.submit(assignment, None)]
print("RESULTS " + json.dumps(dict(
    rank=dist.get_rank(), dynamic=dynamic, lost=lost, lost_at=lost_at,
    plan=[[t.task_id for t in q] for q in assignment.plan],
    runs={{k: [[r.task.task_id, r.executor_id, r.ok, r.model] for r in v]
          for k, v in runs.items()}})), flush=True)

# the example under torchrun (it ends the process group)
from repro_torch.examples import distributed_search
distributed_search.main(["--device", "cpu", "--steps", "1"])
"""


@pytest.fixture(scope="module")
def ranks():
    """Each rank's printed lines (the RESULTS line apart) and its results."""
    texts = run_local_ranks(_RANKS.format(argv=ARGV), 4, timeout=TIMEOUT, env=ENV)
    out = []
    for t in texts:
        lines = t.splitlines()
        res = json.loads(next(x[8:] for x in lines if x.startswith("RESULTS ")))
        res["printed"] = [x for x in lines if re.match(r"  slice \d+: |best after", x)
                          or "LM tasks over" in x]
        res["example"] = [x for x in lines if "mesh slices (estimated" in x
                          and "LM tasks" not in x or "fastest learner" in x]
        out.append(res)
    return out


def test_run_lm_is_the_reference_plan(one_process):
    results, printed = one_process
    ref_tasks, ref_assign = _reference_plan(STEPS)
    tasks = search.lm_search_tasks(None, STEPS)
    assert [(t.task_id, t.estimator, t.params, t.cost) for t in tasks] == \
        [(t.task_id, t.estimator, t.params, t.cost) for t in ref_tasks]
    lines = printed.splitlines()
    assert lines[0] == (f"6 LM tasks over 2 mesh slices (estimated makespan "
                        f"{ref_assign.estimated_makespan:.2e} units)")
    # the results stream slice by slice, each slice's queue in plan order
    want = [(eid, t.task_id) for eid, q in enumerate(ref_assign.plan) for t in q]
    assert [(r.executor_id, r.task.task_id) for r in results] == want
    assert lines[1:7] == [f"  slice {r.executor_id}: {r.task.key():40s} loss={r.model:.4f}"
                          for r in results]
    best = min(results, key=lambda r: r.model)
    assert lines[7] == f"best after {STEPS} steps: {best.task.key()} loss={best.model:.4f}"


@pytest.mark.parametrize("task_id", range(6))
def test_each_task_is_a_one_device_trainer(one_process, task_id):
    """Every result is ok, its loss bit-equal to a one-device ``Trainer``'s."""
    r = next(r for r in one_process[0] if r.task.task_id == task_id)
    assert r.ok and r.error is None
    cfg = configs.get_smoke_config(r.task.estimator)
    stream = make_lm_stream(4, 32, cfg.vocab, device="cpu")
    try:
        m = Trainer(cfg, make_optimizer("adamw", lr=r.task.params["lr"]), stream,
                    device="cpu").run(STEPS)
    finally:
        stream.close()
    assert r.model == m.history[-1]["loss"]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_count_is_the_reference_count_params(arch):
    cfg = configs.get_smoke_config(arch)
    assert count_params(init_params(cfg, device="meta")) == \
        ref_count_params(ref_configs.get_smoke_config(arch))


def test_ranks_run_the_same_tasks_on_the_same_slices(one_process, ranks):
    want = [[r.task.task_id, r.executor_id, True] for r in one_process[0]]
    for rank in ranks:
        for run in ("bf16", "f32"):
            assert [x[:3] for x in rank["runs"][run]] == want, (rank["rank"], run)


@pytest.mark.parametrize("run", ["f32", "bf16"])
def test_ranks_losses_are_the_one_process_losses(one_process, one_process_f32, ranks, run):
    single = {r.task.task_id: r.model
              for r in (one_process_f32 if run == "f32" else one_process)[0]}
    for rank in ranks:
        for task_id, _, _, loss in rank["runs"][run]:
            assert abs(loss - single[task_id]) <= RTOL * abs(single[task_id]), \
                (rank["rank"], task_id, loss, single[task_id])


def test_rank_0_alone_prints(one_process, ranks):
    by_rank = {r["rank"]: r["printed"] for r in ranks}
    assert all(not by_rank[r] for r in (1, 2, 3))
    # the header and the six slice lines twice (bf16, float32), then the
    # dynamic run's header before it raised
    printed = by_rank[0]
    assert printed[0] == one_process[1].splitlines()[0]
    assert len(printed) == 2 * 8 + 1 and printed[8] == printed[0]
    assert printed[-1].startswith("6 LM tasks over 2 mesh slices")
    assert [re.sub(r"loss=\S+", "", x) for x in printed[1:7]] == \
        [re.sub(r"loss=\S+", "", x) for x in one_process[1].splitlines()[1:7]]


def test_dynamic_policies_raise_under_ranks_and_run_in_one_process(ranks):
    for rank in ranks:
        assert rank["dynamic"] is not None and "one queue" in rank["dynamic"]
    results, _ = _run(ARGV + ["--policy", "dynamic", "--steps", "1"])
    assert len(results) == 6 and all(r.ok for r in results)
    assert {r.executor_id for r in results} == {0, 1}


def test_a_lost_slice_ends_its_queue_with_errors_on_every_rank(ranks):
    """``MeshSliceExecutorPool`` on a process mesh: slice 1 lost at its
    second task; its first result stands, the rest of its queue are error
    results; slice 0's queue runs; every rank sees the same results."""
    plan, lost_at = ranks[0]["plan"], ranks[0]["lost_at"]
    want = [[t, 0, True, float(t)] for t in plan[0]] + [[plan[1][0], 1, True, float(plan[1][0])]]
    want += [[t, 1, False, None] for t in plan[1][1:]]
    assert lost_at == plan[1][1]
    for rank in ranks:
        assert rank["lost"] == want, rank["rank"]


def test_the_example_runs_under_torchrun(ranks):
    """``examples/distributed_search.py`` on the 4 ranks (2 slices of 2):
    rank 0 alone prints its header and its best line."""
    assert [len(r["example"]) for r in ranks] == [2, 0, 0, 0]
    assert ranks[0]["example"][0].startswith("6 tasks → 2 mesh slices")


def test_model_par_in_one_process_names_torchrun():
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        search.run_lm(search.parse_args(ARGV + ["--model-par", "2"]))


@pytest.mark.parametrize("example,argv,expect", [
    ("distributed_search", ["--device", "cpu", "--steps", "2"], "fastest learner"),
    ("serve_lm", ["--device", "cpu", "--requests", "6", "--new-tokens", "4"],
     "6 requests, 24 tokens"),
])
def test_examples_run_on_the_cpu(example, argv, expect):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{example}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    assert expect in buf.getvalue()
