"""Model-search launcher — the paper's workload, end to end, on the card.

    python -m repro_torch.launch.search --rows 2000 --scale 0.1 --executors 2 --device cpu
    python -m repro_torch.launch.search --rows 1000000 --scale 1.0 --executors 2   # on the card

``--workload tabular`` (the paper's evaluation): a grid over the paper's
four algorithms (GBDT / MLP / RF / LogReg) on a synthetic HIGGS- or
SECOM-like dataset, with profile-based (or baseline) scheduling over N
thread executors sharing one device. Prints the best model under the
chosen metric. Built as a declarative ``SearchSpec`` run by a ``Session``
(DESIGN.md §2) — results stream as tasks finish, ``--wal`` makes the run
resumable, and ``--max-seconds`` / ``--max-tasks`` / ``--target-metric``
early-stop it mid-stream. Flag for flag the JAX package's launcher, plus
``--device``: it runs on the card unless ``--device cpu`` is given, and
without a card it raises.

``--shards N`` row-shards the prepared data N ways (DESIGN.md §3.9): the
shards' row blocks are stacked on the one device and every family trains on
them through ``compat.sharded_call``.

``--workload lm``: the search space is LM architectures × learning rates
(the smoke configs), and the executors are MESH SLICES — each task trains
its config for ``--steps`` steps on its slice. Costs come from the
analytic profile (parameters × steps). In one process the ``--slices``
slices are logical executors on ``--device`` (the card, or ``cpu``), each
task a one-device ``Trainer``; under ``torchrun`` with ``--slices`` ×
``--model-par`` ranks every slice is a (1, model_par) process mesh and its
tasks train tensor-parallel over it, rank 0 printing every slice's
results:

    python -m repro_torch.launch.search --workload lm --device cpu --steps 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.search --workload lm \
        --device cpu --slices 2 --model-par 2
"""
from __future__ import annotations

import argparse
import os
import time

import repro_torch.tabular  # noqa: F401  (registers the estimators)
from repro_torch import configs
from repro_torch.core import (
    METRICS,
    AnalyticProfiler,
    GridBuilder,
    MeshSliceExecutorPool,
    SamplingProfiler,
    SearchSpec,
    Session,
    TrainTask,
    schedule,
)
from repro_torch.core.executor import is_process_mesh
from repro_torch.data.pipeline import make_lm_stream
from repro_torch.data.synthetic import make_higgs_like, make_secom_like
from repro_torch.device import default_device, set_default_device
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.models import count_params, init_params
from repro_torch.train import Trainer, make_optimizer


def paper_search_space(scale: float = 1.0):
    """The paper's §V-A grid, structurally faithful (scaled for CPU time)."""
    r = lambda n: max(1, int(round(n * scale)))  # noqa: E731
    gbdt = (GridBuilder("gbdt")
            .add_grid("eta", [0.1, 0.3, 0.9])
            .add_grid("round", [r(30), r(60), r(90)])
            .add_grid("max_bin", [32, 64, 128])
            .add_grid("max_depth", [4, 6])
            .build())
    mlp = (GridBuilder("mlp")
           .add_grid("network", ["128_128", "64_64", "128_64", "64_64_64"])
           .add_grid("learning_rate", [0.003, 0.03, 0.3])
           .add_grid("steps", [r(200), r(400)])
           .build())
    forest = (GridBuilder("forest")
              .add_grid("n_estimators", [r(50), r(100)])
              .add_grid("max_depth", [6, 8, 10])
              .build())
    logreg = (GridBuilder("logreg")
              .add_grid("c", [0.011, 0.033, 0.1, 0.3, 0.9])
              .build())
    return [gbdt, mlp, forest, logreg]


def _parse_tuner_args(pairs) -> dict:
    """``--tuner-arg k=v`` values: int, then float, then bare string."""
    out = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(f"--tuner-arg wants k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        for conv in (int, float):
            try:
                v = conv(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def tabular_data(args):
    """The run's (train, valid, test) splits, standardized on train."""
    data = (make_higgs_like(args.rows, seed=0) if args.dataset == "higgs"
            else make_secom_like(seed=0))
    train, valid, test = data.split((0.6, 0.2, 0.2), seed=0)
    train, mu, sd = train.standardize()
    valid, _, _ = valid.standardize(mu, sd)
    test, _, _ = test.standardize(mu, sd)
    return train, valid, test


def run_tabular(args, *, spaces=None, backend=None) -> Session:
    """Run the search ``args`` describes, printing its summary and best
    lines; returns the finished :class:`Session` (its ``multi_model()``
    holds every result). Makes ``args.device`` (default: the card) the
    process's default device, and raises where that device is absent.
    ``spaces`` replaces the paper grid (``paper_search_space(args.scale)``)
    and ``backend`` the Session's own thread pool (e.g. a
    ``MeshSliceExecutorPool``)."""
    set_default_device(default_device(args.device or "cuda"))
    train, valid, test = tabular_data(args)

    spec = SearchSpec(
        spaces=spaces if spaces is not None else paper_search_space(args.scale),
        n_executors=args.executors,
        policy=args.policy,
        profiler=(SamplingProfiler(args.sample_rate) if args.profiler == "sampling"
                  else AnalyticProfiler()),
        tuner=args.tuner,
        tuner_args=(_parse_tuner_args(args.tuner_arg)
                    if args.tuner is not None else None),
        metric=args.metric,
        seed=0,
        wal_path=args.wal,
        max_seconds=args.max_seconds,
        max_tasks=args.max_tasks,
        target_metric=args.target_metric,
        cost_model_path=args.cost_model,
        replan_threshold=args.replan_threshold,
        fuse=args.fuse,
        max_fuse=args.max_fuse,
        max_task_retries=args.max_task_retries,
        deadline_factor=args.deadline_factor,
        n_shards=args.shards,
    )
    print(f"search space: {spec.n_grid_tasks} configurations over "
          f"{[s.estimator for s in spec.spaces]}")
    if args.resume:
        # budgets passed alongside --resume apply to THIS invocation too
        keep = any(v is not None for v in
                   (args.max_seconds, args.max_tasks, args.target_metric))
        session = Session.resume(args.wal, spec, keep_budgets=keep, backend=backend)
    else:
        session = Session(spec, backend)
    t0 = time.perf_counter()
    done = 0
    for r in session.results(train, valid):
        done += 1
        if args.verbose and r.ok:
            # full per-task cost breakdown (§3.3/§3.4): train + convert +
            # executor-side eval, the fused batch it rode in, and the score
            # it streamed back with — no driver-side re-predicting
            extras = f"{r.train_seconds:.2f}s train"
            if r.convert_seconds:
                extras += f" +{r.convert_seconds:.2f}s conv"
            if r.eval_seconds:
                extras += f" +{r.eval_seconds:.3f}s eval"
            if r.batch_size > 1:
                extras += f", batch={r.batch_size}"
            if r.score is not None:
                extras += f", {args.metric}={r.score:.4f}"
            print(f"  [{done}/{spec.n_grid_tasks}] exec {r.executor_id}: "
                  f"{r.task.key()} ({extras})")
    multi = session.multi_model()
    if not len(multi):
        print("nothing left to search (WAL already complete?)")
        return session
    best = multi.best(valid, metric=args.metric)
    test_score = None
    for r in multi.results:
        if r.task.task_id == best.task.task_id:
            test_score = METRICS[args.metric](test.y, r.model.predict_proba(test.x))
    stopped = f" stop={session.stop_reason}" if session.stop_reason else ""
    feedback = ""
    if session.cost_model is not None:
        feedback = (f" replans={session.stats.n_replans} "
                    f"model_estimates={session.stats.n_model_estimates} "
                    f"profiled={session.stats.n_profiled} "
                    f"cost_model={session.cost_model.path or '<memory>'}")
    st = session.stats
    fused = ""
    if spec.fuse:
        fused = (f" fused_batches={st.n_fused_batches}"
                 f" fused_tasks={st.n_fused_tasks}"
                 f" compile_cache={st.compile_cache_hits}h/"
                 f"{st.compile_cache_misses}m")
    prepared = (f" prepared_cache={st.prepared_cache_hits}h/"
                f"{st.prepared_cache_misses}m"
                f" convert={st.convert_seconds_total:.2f}s")
    evald = (f" eval={st.eval_seconds_total:.2f}s"
             f" predict_cache={st.predict_compile_cache_hits}h/"
             f"{st.predict_compile_cache_misses}m")
    print(f"policy={args.policy} total={time.perf_counter() - t0:.1f}s "
          f"profiling_ratio={st.profiling_ratio:.1%} "
          f"failures={st.n_failures}{stopped}{feedback}{fused}{prepared}"
          f"{evald}")
    print(f"best: {best.task.key()}  valid {args.metric}={best.score:.4f} "
          f"test {args.metric}={test_score:.4f} "
          f"(train {best.train_seconds:.2f}s + conv {best.convert_seconds:.2f}s "
          f"+ eval {best.eval_seconds:.3f}s, batch={best.batch_size})")
    return session


def lm_search_tasks(archs: str | None, steps: int) -> list[TrainTask]:
    """The LM grid, (architecture × lr {1e-3, 3e-3}), each task costed
    analytically as its smoke config's parameter count × ``steps``
    (counted on the ``meta`` device: no weights are drawn)."""
    spaces = [GridBuilder(arch).add_grid("lr", [1e-3, 3e-3]).build()
              for arch in (archs.split(",") if archs else
                           ["qwen2_1_5b", "tinyllama_1_1b", "gemma_2b"])]
    tasks = []
    for space in spaces:
        cfg = configs.get_smoke_config(space.estimator)
        cost = count_params(init_params(cfg, device="meta")) * steps
        for cfg_params in space.configs:
            tasks.append(TrainTask(task_id=len(tasks), estimator=space.estimator,
                                   params=dict(cfg_params), cost=float(cost)))
    return tasks


def lm_task_runner(steps: int):
    """``task_runner(task, slice, data) -> (final loss, seconds)``: the
    task's smoke config trained ``steps`` steps with AdamW at its lr, on a
    batch of 4 × 32 tokens of seed 0; a one-device ``Trainer`` on a logical
    slice's device, or a ``Trainer`` over a process-mesh slice."""
    def run(task: TrainTask, sl, _data):
        cfg = configs.get_smoke_config(task.estimator)
        where = dict(mesh=sl) if is_process_mesh(sl) else dict(device=sl.device)
        stream = make_lm_stream(4, 32, cfg.vocab, **where)
        tr = Trainer(cfg, make_optimizer("adamw", lr=task.params["lr"]), stream, **where)
        t0 = time.perf_counter()
        try:
            m = tr.run(steps)
        finally:
            stream.close()
        return m.history[-1]["loss"], time.perf_counter() - t0

    return run


def lm_search_mesh(slices: int, model_par: int, device):
    """``(mesh, say)``: the mesh the LM search's slices are cut from, and
    ``print`` on rank 0 (a no-op elsewhere). Under ``torchrun``
    (``WORLD_SIZE`` > 1) the (slices, model_par) process mesh, each slice
    tensor-parallel over its ``model`` ranks; in one process the logical
    (slices, 1) mesh of ``device``, where ``model_par`` > 1 raises."""
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        mesh = make_test_mesh(data=slices, model=model_par, device=device)
        return mesh, print if mesh.get_rank() == 0 else (lambda *a, **k: None)
    if model_par > 1:
        raise RuntimeError(
            f"--model-par {model_par} spreads each task over ranks: run it under "
            f"torchrun --nproc-per-node {slices * model_par}")
    set_default_device(device)
    return make_mesh((slices, 1), ("data", "model"), device), print


def run_lm(args) -> list:
    """The LM search on mesh-slice executors; prints the reference's lines
    (rank 0 alone under ``torchrun``) and returns every slice's
    ``TaskResult``s."""
    mesh, say = lm_search_mesh(args.slices, args.model_par,
                               default_device(args.device or "cuda"))
    tasks = lm_search_tasks(args.archs, args.steps)
    assignment = schedule(tasks, args.slices, policy=args.policy)
    say(f"{len(tasks)} LM tasks over {args.slices} mesh slices "
        f"(estimated makespan {assignment.estimated_makespan:.2e} units)")
    pool = MeshSliceExecutorPool(mesh, args.slices, lm_task_runner(args.steps))
    results = []
    for r in pool.submit(assignment, None):     # streams slice by slice
        status = f"loss={r.model:.4f}" if r.ok else f"ERROR {r.error}"
        say(f"  slice {r.executor_id}: {r.task.key():40s} {status}")
        results.append(r)
    best = min((r for r in results if r.ok), default=None, key=lambda r: r.model)
    if best is not None:
        say(f"best after {args.steps} steps: {best.task.key()} loss={best.model:.4f}")
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="tabular", choices=("tabular", "lm"))
    p.add_argument("--dataset", default="higgs", choices=("higgs", "secom"))
    p.add_argument("--rows", type=int, default=8000)
    p.add_argument("--executors", type=int, default=4)
    p.add_argument("--policy", default="lpt",
                   choices=("lpt", "random", "round_robin", "dynamic", "lpt_dynamic"))
    p.add_argument("--profiler", default="sampling", choices=("sampling", "analytic"))
    p.add_argument("--sample-rate", type=float, default=0.03)
    p.add_argument("--tuner", default=None,
                   choices=("grid", "random", "asha", "surrogate"),
                   help="search strategy over the declared spaces "
                        "(default: exhaustive grid). 'asha' runs adaptive "
                        "successive halving on the streaming eval plane "
                        "(DESIGN.md §3.6)")
    p.add_argument("--tuner-arg", action="append", metavar="K=V",
                   help="tuner kwarg, repeatable — e.g. --tuner asha "
                        "--tuner-arg base_budget=10 --tuner-arg "
                        "max_budget=270 --tuner-arg eta=3")
    p.add_argument("--metric", default="auc")
    p.add_argument("--scale", type=float, default=0.3,
                   help="search-space budget scale (1.0 = paper-sized)")
    p.add_argument("--wal", default=None, help="WAL path for restartable search")
    p.add_argument("--resume", action="store_true",
                   help="resume a search whose WAL is at --wal")
    p.add_argument("--cost-model", default=None, metavar="PATH",
                   help="persistent CostModel JSON: observed runtimes feed a "
                        "learned profiler that replaces sampling once warm "
                        "(defaults to <wal>.cost.json when --replan-threshold "
                        "is set alongside --wal)")
    p.add_argument("--replan-threshold", type=float, default=None, metavar="DRIFT",
                   help="re-run rebalance mid-round when mean |log(observed/"
                        "estimated)| exceeds this (0.69 ≈ runtimes 2x off)")
    p.add_argument("--fuse", action="store_true",
                   help="pack same-family configs into fused batches that "
                        "train as one stacked program (DESIGN.md §3.2)")
    p.add_argument("--max-fuse", type=int, default=16, metavar="N",
                   help="largest fused batch (configs per program, default 16)")
    p.add_argument("--shards", type=int, default=1, metavar="N",
                   help="row-shard the prepared data N ways (DESIGN.md §3.9): "
                        "per-shard residency, cross-shard histogram sums")
    p.add_argument("--max-task-retries", type=int, default=0, metavar="N",
                   help="re-run a task whose train raises up to N times "
                        "(capped exponential backoff) before it surfaces "
                        "as a terminal error (DESIGN.md §3.7)")
    p.add_argument("--deadline-factor", type=float, default=None, metavar="F",
                   help="soft deadline: a task in flight longer than F × "
                        "its CostModel-predicted cost is speculatively "
                        "duplicated on an idle executor; first completion "
                        "wins (DESIGN.md §3.7)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="early-stop budget: wall-clock seconds")
    p.add_argument("--max-tasks", type=int, default=None,
                   help="early-stop budget: trained-task count")
    p.add_argument("--target-metric", type=float, default=None,
                   help="early-stop as soon as a model reaches this score")
    p.add_argument("--verbose", action="store_true",
                   help="print each task result as it streams in")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run on the CPU)")
    # lm workload
    p.add_argument("--slices", type=int, default=2)
    p.add_argument("--model-par", type=int, default=1)
    p.add_argument("--archs", default=None)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    if args.resume and not args.wal:
        p.error("--resume requires --wal")
    if args.tuner_arg and not args.tuner:
        p.error("--tuner-arg requires --tuner")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.workload == "tabular":
        run_tabular(args)
        return 0
    run_lm(args)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
