"""Multi-tenant search quickstart (DESIGN.md §3.5 + §3.6), on the PyTorch port.

One process, one :class:`repro_torch.serve.SearchService`: three tenants
submit searches concurrently against the SAME shared executors and caches —
two exhaustive grids plus one ASHA session whose rung tasks interleave with
them — fair-share arbitration interleaves their training units, the
prepared-data cache is built once and hit by both, every observation feeds
the fleet CostModel so later tenants plan warm, and the per-tenant ledger
in the printed ServiceStats sums exactly to the shared caches' globals:

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_search
    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_search --device cpu
"""
import argparse
import tempfile

import repro_torch.tabular  # noqa: F401 — registers all implementations
from repro_torch import set_default_device
from repro_torch.core import GridBuilder, SearchSpec
from repro_torch.data.synthetic import make_higgs_like
from repro_torch.serve import SearchService


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    p.add_argument("--rows", type=int, default=2000)
    args = p.parse_args(argv)
    if args.device is not None:
        set_default_device(args.device)
    rows = args.rows

    # ----- two tenants' search spaces ----------------------------------------
    alice_spaces = [
        GridBuilder("logreg").add_grid("c", [0.011, 0.1, 0.9]).build(),
        GridBuilder("forest").add_grid("n_estimators", [5])
                             .add_grid("max_depth", [4, 6]).build(),
    ]
    bob_spaces = [
        GridBuilder("logreg").add_grid("c", [0.033, 0.3]).build(),
        GridBuilder("forest").add_grid("n_estimators", [5])
                             .add_grid("max_depth", [8]).build(),
    ]
    # carol runs ADAPTIVE search (DESIGN.md §3.6): an ASHA ladder over gbdt,
    # sharing the same workers/caches as the grid tenants — rung tasks are
    # ordinary schedulable units to the fair-share arbiter
    carol_spaces = [
        GridBuilder("gbdt").add_grid("eta", [0.1, 0.3, 0.9])
                           .add_grid("max_depth", [4, 6]).build(),
    ]

    # ----- shared data --------------------------------------------------------
    data = make_higgs_like(rows, seed=0)
    train_df, validate_df = data.split((0.8, 0.2), seed=0)
    train_df, mu, sd = train_df.standardize()
    validate_df, _, _ = validate_df.standardize(mu, sd)

    with tempfile.TemporaryDirectory() as artifacts:
        # 4 shared workers, up to 8 concurrent sessions, 256 MiB cache budget;
        # per-tenant WALs + the fleet cost model live under `artifacts`
        service = SearchService(n_executors=4, max_active=8,
                                artifact_root=artifacts,
                                cache_budget_bytes=256 << 20)
        try:
            # both searches are live at once — units interleave 2:1 on the
            # shared workers instead of running back to back
            alice = service.submit_search(
                SearchSpec(spaces=alice_spaces, n_executors=4),
                train_df, validate_df, tenant="alice", weight=2.0)
            # bob runs SHARDED (DESIGN.md §3.9): his prepared variants resolve
            # under a ShardedPlacement key, so his per-device residency is ~1/2
            # a full copy while alice/carol keep training on replicated entries
            # in the SAME budget-governed cache
            bob = service.submit_search(
                SearchSpec(spaces=bob_spaces, n_executors=4, n_shards=2),
                train_df, validate_df, tenant="bob", weight=1.0)
            carol = service.submit_search(
                SearchSpec(spaces=carol_spaces, n_executors=4, tuner="asha",
                           tuner_args={"base_budget": 3, "max_budget": 12,
                                       "eta": 2}),
                train_df, validate_df, tenant="carol", weight=1.0)

            carol_results = []
            for handle in (alice, bob, carol):
                for result in handle.results():   # streams in completion order
                    if handle is carol:
                        carol_results.append(result)
                    print(f"  [{handle.tenant}] {result.task.estimator} "
                          f"auc={-1.0 if result.score is None else result.score:.4f}")
                best = handle.multi_model().best(validate_df)
                print(f"{handle.tenant}: best {best.task.estimator} "
                      f"auc={best.score:.4f} "
                      f"(time-to-first-result {handle.time_to_first_result:.2f}s)")

            # the §3.6 coexistence check: the adaptive session ran a real
            # ladder on the SAME shared workers as the grid tenants — every
            # carol unit is a rung task, promotions reached the budget cap,
            # and promoted rungs resumed (prev_budget > 0) rather than
            # retraining from scratch
            from repro_torch.core import RungTask
            assert carol_results and all(
                isinstance(r.task, RungTask) and r.ok for r in carol_results)
            assert max(r.task.budget for r in carol_results) == 12
            assert any(r.task.prev_budget > 0 for r in carol_results)

            stats = service.stats()
            print()
            print(stats.summary())
            # the §3.5 ledger invariant: per-tenant counters sum EXACTLY to the
            # shared cache's globals — no unattributed traffic
            hits, misses = service.prepared_cache.counters()
            per_tenant = service.prepared_cache.tenant_counters()
            assert sum(v.get("hits", 0) for v in per_tenant.values()) == hits
            assert sum(v.get("misses", 0) for v in per_tenant.values()) == misses
            # the §3.9 coexistence check: bob's row-sharded entries live in the
            # same governed cache as the replicated ones — the sharded residency
            # gauge is nonzero (his per-shard blocks) yet strictly smaller than
            # the cache total (alice/carol's full copies are in there too), and
            # bob's ledger traffic is attributed like anyone else's
            sharded_bytes = service.prepared_cache.sharded_resident_bytes()
            assert 0 < sharded_bytes < service.prepared_cache.bytes_cached
            assert per_tenant.get("bob", {}).get("misses", 0) > 0
            print(f"sharded coexistence: bob holds {sharded_bytes}B of per-shard "
                  f"blocks inside the {service.prepared_cache.bytes_cached}B "
                  "shared cache")
            # bob's plan was priced from shared fleet experience, not profiling
            assert stats.fleet_observations > 0
        finally:
            service.close()
    print("multi-tenant search OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
