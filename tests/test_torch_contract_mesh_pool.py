"""The JAX package's ``tests/test_mesh_pool.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    MeshSliceExecutorPool scheduling semantics, tested WITHOUT devices:
    stand-in slice handles + a recording task_runner exercise WAL resume,
    per-task error capture, dynamic load balancing, failure re-queue, and
    fused-batch unbatching/straggler recovery.
"""
import pytest

from repro_torch.core import (
    ExecutorFailure,
    FusedBatch,
    MeshSliceExecutorPool,
    SearchWAL,
    TrainTask,
    schedule,
)

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


def mk_tasks(costs):
    return [TrainTask(task_id=i, estimator="stub", params={"i": i}, cost=c)
            for i, c in enumerate(costs)]


class RecordingRunner:
    """task_runner that logs (task_id, slice) and can fail on demand."""

    def __init__(self, errors=(), die_on=()):
        self.calls: list[tuple[int, object]] = []
        self.errors = set(errors)        # task_ids -> task-level exception
        self.die_on = set(die_on)        # (slice_label, task_id) -> slice death

    def __call__(self, task, slice_mesh, data):
        if (slice_mesh, task.task_id) in self.die_on:
            self.die_on.discard((slice_mesh, task.task_id))
            raise ExecutorFailure(f"{slice_mesh} died")
        self.calls.append((task.task_id, slice_mesh))
        if task.task_id in self.errors:
            raise ValueError(f"task {task.task_id} is poisoned")
        return f"model-{task.task_id}", 0.01


def test_requires_mesh_or_slices():
    with pytest.raises(ValueError):
        MeshSliceExecutorPool(task_runner=RecordingRunner())
    # task_runner is OPTIONAL since §3.3: slices alone build the
    # estimator-backed default pool (per-slice prepared-data placement)
    pool = MeshSliceExecutorPool(slices=["s0"])
    assert pool.task_runner is None and pool.n_executors == 1


def test_wal_resume_skips_done_tasks(tmp_path):
    wal_path = str(tmp_path / "wal.jsonl")
    tasks = mk_tasks([1.0] * 4)
    assignment = schedule(tasks, 2, policy="lpt")

    r1 = RecordingRunner()
    pool1 = MeshSliceExecutorPool(task_runner=r1, slices=["s0", "s1"],
                                  wal=SearchWAL(wal_path))
    results = pool1.run(assignment, data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3]
    assert len(r1.calls) == 4

    # fresh pool, same WAL file: nothing re-runs, nothing is yielded
    r2 = RecordingRunner()
    pool2 = MeshSliceExecutorPool(task_runner=r2, slices=["s0", "s1"],
                                  wal=SearchWAL(wal_path))
    assert pool2.run(assignment, data=None) == []
    assert r2.calls == []


def test_per_task_error_capture(tmp_path):
    wal_path = str(tmp_path / "wal.jsonl")
    tasks = mk_tasks([1.0] * 3)
    runner = RecordingRunner(errors={1})
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0"],
                                 wal=SearchWAL(wal_path))
    results = pool.run(schedule(tasks, 1, policy="round_robin"), data=None)
    assert len(results) == 3
    by_id = {r.task.task_id: r for r in results}
    assert by_id[0].ok and by_id[2].ok
    assert not by_id[1].ok and "poisoned" in by_id[1].error
    assert pool.dead_executors == set()      # a bad task never kills the slice
    # failures stay out of the WAL → a resumed pool retries exactly task 1
    retry = RecordingRunner()
    pool2 = MeshSliceExecutorPool(task_runner=retry, slices=["s0"],
                                  wal=SearchWAL(wal_path))
    again = pool2.run(schedule(tasks, 1, policy="round_robin"), data=None)
    assert [r.task.task_id for r in again] == [1]
    assert again[0].ok


def test_dynamic_queue_assignment_balances_load():
    tasks = mk_tasks([8.0, 7.0, 2.0, 1.0, 1.0, 1.0])
    runner = RecordingRunner()
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"])
    results = pool.run(schedule(tasks, 2, policy="dynamic"), data=None)
    assert len(results) == 6
    loads = {"s0": 0.0, "s1": 0.0}
    for r in results:
        loads[pool.slices[r.executor_id]] += r.task.cost
    # least-loaded placement of longest-first tasks: loads end up 10 vs 10,
    # never the 17-vs-3 a naive contiguous split would give
    assert abs(loads["s0"] - loads["s1"]) <= max(t.cost for t in tasks)
    assert set(s for _, s in runner.calls) == {"s0", "s1"}


def test_dynamic_assignment_skips_wal_done(tmp_path):
    wal = SearchWAL(str(tmp_path / "wal.jsonl"))
    tasks = mk_tasks([3.0, 2.0, 1.0, 1.0])
    runner = RecordingRunner()
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"], wal=wal)
    first = pool.run(schedule(tasks[:2], 2, policy="dynamic"), data=None)
    assert len(first) == 2
    # re-submitting the full set only runs the two new tasks
    rest = pool.run(schedule(tasks, 2, policy="dynamic"), data=None)
    assert sorted(r.task.task_id for r in rest) == [2, 3]
    assert sorted(t for t, _ in runner.calls) == [0, 1, 2, 3]


def test_slice_failure_requeues_to_survivors():
    tasks = mk_tasks([1.0] * 6)
    runner = RecordingRunner(die_on={("s0", 0)})
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1", "s2"])
    results = pool.run(schedule(tasks, 3, policy="round_robin"), data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3, 4, 5]
    assert all(r.ok for r in results)
    assert pool.dead_executors == {0}
    assert all(s != "s0" for _, s in runner.calls)   # survivors did everything


def test_last_survivor_dies_mid_requeue():
    """Slice 0 dies on its own queue; slice 1 finishes its queue, then dies
    on the FIRST re-queued task — the remaining stranded work must fall
    through to the driver, not crash the re-queue loop."""
    tasks = mk_tasks([1.0] * 6)
    # round_robin: s0 [0,1,2], s1 [3,4,5]; ("s1", 0) fires during re-queue
    runner = RecordingRunner(die_on={("s0", 0), ("s1", 0)})
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"])
    results = pool.run(schedule(tasks, 2, policy="round_robin"), data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3, 4, 5]
    assert all(r.ok for r in results)
    assert pool.dead_executors == {0, 1}
    # tasks 0..2 were stranded twice and ran inline on the driver
    assert {r.executor_id for r in results if r.task.task_id in (0, 1, 2)} == {-1}


def test_all_slices_dead_falls_back_to_driver():
    tasks = mk_tasks([1.0] * 4)
    # each slice dies on the first task of its own queue (round_robin gives
    # s0 [0,1] and s1 [2,3]) → no survivors → driver-inline recovery
    runner = RecordingRunner(die_on={("s0", 0), ("s1", 2)})
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"])
    results = pool.run(schedule(tasks, 2, policy="round_robin"), data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3]
    assert pool.dead_executors == {0, 1}
    assert {r.executor_id for r in results} == {-1}  # driver ran everything
    assert all(pool.wal.is_done(t.task_id) for t in tasks)


def test_streaming_yields_before_completion():
    tasks = mk_tasks([1.0] * 4)
    runner = RecordingRunner()
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"])
    stream = pool.submit(schedule(tasks, 2, policy="lpt"), data=None)
    first = next(stream)
    assert len(runner.calls) == 1            # exactly one task has run so far
    assert first.ok
    rest = list(stream)
    assert len(rest) == 3


# --------------------------------------------------------------------------
# Fused batches: one program per unit, unbatched results, stragglers.
# --------------------------------------------------------------------------

class BatchAwareRunner(RecordingRunner):
    """Runner that also accepts FusedBatch units (one call per unit)."""

    def __call__(self, task, slice_mesh, data):
        if isinstance(task, FusedBatch):
            if (slice_mesh, task.task_id) in self.die_on:
                self.die_on.discard((slice_mesh, task.task_id))
                raise ExecutorFailure(f"{slice_mesh} died")
            self.calls.append((task.task_id, slice_mesh))
            return [f"model-{m.task_id}" for m in task.tasks], 0.04 * task.batch_size
        return super().__call__(task, slice_mesh, data)


def mk_fused(costs, start=0):
    tasks = [TrainTask(task_id=start + i, estimator="stub", params={"i": i}, cost=c)
             for i, c in enumerate(costs)]
    return FusedBatch(tasks=tuple(tasks), signature=("stub", ()),
                      buckets=(0,) * len(tasks), cost=float(sum(costs)))


def test_fused_unit_unbatches_with_amortized_seconds(tmp_path):
    wal = SearchWAL(str(tmp_path / "wal.jsonl"))
    unit = mk_fused([1.0] * 4)
    runner = BatchAwareRunner()
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0"], wal=wal)
    results = pool.run(schedule([unit], 1, policy="lpt"), data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3]
    assert len(runner.calls) == 1            # ONE program for the whole unit
    assert all(r.batch_size == 4 for r in results)
    assert all(r.train_seconds == pytest.approx(0.04) for r in results)
    assert all(wal.is_done(t) for t in range(4))
    # resubmitting skips every journalled member without running anything
    again = MeshSliceExecutorPool(task_runner=BatchAwareRunner(),
                                  slices=["s0"], wal=SearchWAL(wal.path))
    assert again.run(schedule([unit], 1, policy="lpt"), data=None) == []


def test_fused_batch_error_becomes_per_member_errors():
    class ExplodingRunner(BatchAwareRunner):
        def __call__(self, task, slice_mesh, data):
            raise ValueError("batch is poisoned")

    pool = MeshSliceExecutorPool(task_runner=ExplodingRunner(), slices=["s0"])
    results = pool.run(schedule([mk_fused([1.0] * 3)], 1, policy="lpt"), data=None)
    assert len(results) == 3
    assert all(not r.ok and "poisoned" in r.error for r in results)
    assert pool.dead_executors == set()      # a bad batch never kills the slice


def test_fused_stragglers_survive_mid_stream_cancel(tmp_path):
    """Fault parity with LocalExecutorPool.drain_stragglers: a replanning
    driver that cancels the stream mid-unbatch must be able to collect the
    finished members it never saw — they are journalled, and losing their
    models would silently waste trained work."""
    wal = SearchWAL(str(tmp_path / "wal.jsonl"))
    unit = mk_fused([1.0] * 5)
    pool = MeshSliceExecutorPool(task_runner=BatchAwareRunner(),
                                 slices=["s0"], wal=wal)
    stream = pool.submit(schedule([unit], 1, policy="lpt"), data=None)
    seen = [next(stream), next(stream)]
    stream.close()                           # replan-style cancellation
    stragglers = pool.drain_stragglers()
    assert len(stragglers) == 3
    assert {r.task.task_id for r in seen} | {r.task.task_id for r in stragglers} \
        == {0, 1, 2, 3, 4}
    assert all(r.ok for r in stragglers)
    assert all(wal.is_done(t) for t in range(5))
    assert pool.drain_stragglers() == []     # buffer clears on read


def test_fused_unit_requeues_to_survivor_on_slice_death(tmp_path):
    """A slice dying ON a fused unit strands the whole unit; the survivor
    re-runs it as one program."""
    unit = mk_fused([1.0] * 3)
    single = TrainTask(task_id=99, estimator="stub", params={}, cost=1.0)
    runner = BatchAwareRunner(die_on={("s0", unit.task_id)})
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"],
                                 wal=SearchWAL(str(tmp_path / "wal.jsonl")))
    results = pool.run(schedule([unit, single], 2, policy="lpt"), data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 99]
    assert all(r.ok for r in results)
    assert pool.dead_executors == {0}
    assert all(s == "s1" for _, s in runner.calls)   # survivor did everything


# --------------------------------------------------------------------------
# Pinning paths (§3.7): plans wider than the pool, and total executor loss.
# --------------------------------------------------------------------------

def test_excess_plan_queues_are_not_dropped():
    """A plan built for MORE executors than the pool has slices: the extra
    queues' tasks must still surface (the old zip() silently dropped them)."""
    tasks = mk_tasks([1.0] * 6)
    runner = RecordingRunner()
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"])
    # round_robin over 4 queues: q2=[2] and q3=[3] have no slice to run on
    results = pool.run(schedule(tasks, 4, policy="round_robin"), data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3, 4, 5]
    assert all(r.ok for r in results)
    assert pool.dead_executors == set()      # stranded ≠ dead
    assert {s for _, s in runner.calls} == {"s0", "s1"}


def test_driver_fallback_death_surfaces_typed_errors(tmp_path):
    """Every slice dead AND the driver-inline fallback dying too: stranded
    tasks surface as AllExecutorsLost error results — never vanish, never
    journal."""
    from repro_torch.core import AllExecutorsLost  # noqa: F401 — typed error

    tasks = mk_tasks([1.0] * 4)
    # round_robin: s0 [0,1], s1 [2,3]; both die on their first task, then
    # the driver (slice handle "s0") dies again on tasks 1 and 3
    runner = RecordingRunner(
        die_on={("s0", 0), ("s1", 2), ("s0", 1), ("s0", 3)})
    pool = MeshSliceExecutorPool(task_runner=runner, slices=["s0", "s1"],
                                 wal=SearchWAL(str(tmp_path / "wal.jsonl")))
    results = pool.run(schedule(tasks, 2, policy="round_robin"), data=None)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3]
    assert pool.dead_executors == {0, 1}
    by_id = {r.task.task_id: r for r in results}
    assert by_id[0].ok and by_id[2].ok       # driver salvaged what it could
    for tid in (1, 3):
        assert not by_id[tid].ok
        assert "AllExecutorsLost" in by_id[tid].error
        assert not pool.wal.is_done(tid)     # failures stay out of the WAL
