"""Quickstart — the paper's Fig. 1 example, on the PyTorch port.

Declares a search space over THREE implementation families (the port's
GBDT standing in for XGBoost, its MLP for TensorFlow, logreg/forest for
scikit-learn) as one frozen SearchSpec, streams results from a Session
as the profile-scheduled search runs on the card, and validates every
produced model:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --rows 2000
"""
import argparse

import repro_torch.tabular  # noqa: F401 — registers all implementations
from repro_torch import set_default_device
from repro_torch.core import GridBuilder, SamplingProfiler, SearchSpec, Session
from repro_torch.data.synthetic import make_higgs_like


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    p.add_argument("--rows", type=int, default=8000)
    args = p.parse_args(argv)
    if args.device is not None:
        set_default_device(args.device)
    rows = args.rows

    # ----- search space (paper Fig. 1, first half) ---------------------------
    xgb_grid = (GridBuilder("gbdt")
                .add_grid("eta", [0.1, 0.3, 0.9])
                .add_grid("round", [10, 20, 30])
                .add_grid("max_bin", [32, 64, 128])
                .build())
    tf_grid = (GridBuilder("mlp")
               .add_grid("network", ["128_128", "64_64", "128_64", "64_64_64"])
               .add_grid("learning_rate", [0.003, 0.03, 0.3])
               .build())
    sklearn_lr_grid = (GridBuilder("logreg")
                       .add_grid("c", [0.011, 0.033, 0.1, 0.3, 0.9])
                       .build())

    # ----- declarative spec (replaces the mutable builder) -------------------
    # The fault plane (DESIGN.md §3.7) rides the same spec: max_task_retries
    # re-runs a config whose train raises (capped exponential backoff) before
    # it surfaces as a terminal error, and deadline_factor=F speculatively
    # duplicates any task running longer than F x its predicted cost. The
    # launcher exposes both as --max-task-retries / --deadline-factor.
    spec = SearchSpec(
        spaces=[xgb_grid, tf_grid, sklearn_lr_grid],
        n_executors=4,
        policy="lpt",
        profiler=SamplingProfiler(0.01),
        max_task_retries=1,
    )

    # ----- model search (paper Fig. 1, second half) --------------------------
    data = make_higgs_like(rows, seed=0)
    train_df, validate_df = data.split((0.8, 0.2), seed=0)
    train_df, mu, sd = train_df.standardize()
    validate_df, _, _ = validate_df.standardize(mu, sd)

    session = Session(spec)
    done = 0
    # passing the validation split turns on the fused validation plane
    # (DESIGN.md §3.4): each executor scores the models it trained — batched
    # inference against a cached device-resident eval split — so every
    # streamed result already carries its auc as result.score
    for result in session.results(train_df, validate_df):
        done += 1
        if done % 10 == 0:
            print(f"  ... {done}/{spec.n_grid_tasks} tasks done "
                  f"(latest {result.task.estimator} auc="
                  f"{-1.0 if result.score is None else result.score:.4f})")
    multi_model = session.multi_model()
    scores = multi_model.validate_all(validate_df, metric="auc")

    print(f"searched {len(scores)} configurations "
          f"(profiling {session.stats.profiling_ratio:.1%} of total time)")
    # Prepared-data plane (DESIGN.md §3.3): each (dataset, format, params)
    # variant converts ONCE per process — misses = actual conversions, hits =
    # tasks that trained on the device-resident prepared copy for free.
    st = session.stats
    print(f"prepared-data cache: {st.prepared_cache_misses} conversions, "
          f"{st.prepared_cache_hits} reuses, "
          f"{st.convert_seconds_total:.2f}s converting "
          f"({st.prepared_cache_hit_rate:.0%} hit rate)")
    # Fused validation plane (§3.4): scoring happened executor-side, where each
    # model trained — the driver never re-predicted to rank the stream.
    print(f"validation plane: {st.eval_seconds_total:.2f}s scoring executor-side, "
          f"predict compile cache {st.predict_compile_cache_misses} builds / "
          f"{st.predict_compile_cache_hits} reuses")
    for m in scores[:5]:
        print(f"  auc={m.score:.4f}  {m.task.key()}")
    print(f"best: {scores[0].task.key()}")

    # ----- adaptive search (DESIGN.md §3.6) ----------------------------------
    # The grid above trained every config at its full budget. ASHA ladders the
    # budget instead: every gbdt config gets 10 boosting rounds, the top 1/eta
    # per rung RESUME (train_resumable — only the increment is trained) at 3x
    # the budget, and the losers are never scheduled again.
    asha_grid = (GridBuilder("gbdt")            # no "round" axis: ASHA owns it
                 .add_grid("eta", [0.1, 0.3, 0.9])
                 .add_grid("max_depth", [4, 6, 8])
                 .add_grid("max_bin", [32, 64, 128])
                 .build())
    asha_spec = SearchSpec(
        spaces=[asha_grid],
        n_executors=4,
        tuner="asha",
        tuner_args={"base_budget": 10, "max_budget": 90, "eta": 3},
        profiler=SamplingProfiler(0.01),
    )
    asha_session = Session(asha_spec)
    rungs = list(asha_session.results(train_df, validate_df))
    spent = sum(r.task.budget - r.task.prev_budget for r in rungs if r.ok)
    best = max((r for r in rungs if r.ok and r.score is not None),
               key=lambda r: r.score)
    print(f"asha: {len(rungs)} rung tasks, {spent} boosting rounds trained "
          f"(grid at full budget would train {27 * 90}), "
          f"best auc={best.score:.4f} at {best.task.key()}")

    # ----- sharded search (DESIGN.md §3.9) -----------------------------------
    # n_shards=4 row-shards every prepared variant into 4 blocks: GBDT builds
    # per-shard histograms combined with ONE psum before the split scan (split
    # decisions identical to single-device), logreg/mlp do data-parallel grad
    # psums, and the eval plane reduces per-shard metric partials — so each
    # (virtual) device holds ~1/4 of a full prepared copy. The launcher flag
    # for the same thing is `--shards 4`.
    sharded_spec = SearchSpec(
        spaces=[sklearn_lr_grid],
        n_executors=2,
        n_shards=4,
        profiler=SamplingProfiler(0.01),
    )
    sharded_session = Session(sharded_spec)
    sharded = [r for r in sharded_session.results(train_df, validate_df) if r.ok]
    sst = sharded_session.stats
    best_sh = max(sharded, key=lambda r: r.score)
    print(f"sharded: {len(sharded)} configs at n_shards=4, "
          f"shard residency {sst.shard_residency_bytes}B per device "
          f"(vs a full replicated copy), best auc={best_sh.score:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
