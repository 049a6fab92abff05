"""Serving launcher, the JAX package's ``launch/serve.py``. Two modes:

* LM token serving:

      python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
      python -m repro_torch.launch.serve --arch whisper-medium --smoke --device cpu
      python -m repro_torch.launch.serve --arch rwkv6-7b           # on the card

  (any of the ten architectures of ``repro_torch.configs``) builds a ServeEngine on freshly initialised (seeded) weights and drives a
  synthetic stream of requests through prefill + greedy decode in waves of
  ``--batch``, reporting tokens/s.

* Multi-tenant model search (DESIGN.md §3.5):

      python -m repro_torch.launch.serve --search-service --device cpu \
          --tenant-weight alice=2 --tenant-weight bob=1

  boots a :class:`repro_torch.serve.SearchService` and runs one concurrent
  search per declared tenant on shared executors, fair-share arbitrated,
  printing per-tenant ServiceStats (makespan, wait, cache hits, share
  drift).

Both run on the card unless ``--device cpu`` is given; without a card they
raise. ``--ckpt-dir D`` serves the weights of the newest checkpoint under
``D`` (written by ``launch.train`` on one device or on any mesh).
``--mesh data,model`` other than ``1,1`` serves on a device mesh, one rank
per entry under ``torchrun`` (NCCL on the cards, gloo with ``--device
cpu``); every rank serves the same waves and rank 0 prints:

      torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch gemma-2b --smoke \
          --device cpu --mesh 2,2
"""
from __future__ import annotations

import argparse
import time


def run_lm_serve(args) -> int:
    import numpy as np

    from repro_torch import configs
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.device import default_device
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    data_sz, model_sz = (int(x) for x in args.mesh.split(","))
    mesh = None
    if (data_sz, model_sz) != (1, 1):
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(data=data_sz, model=model_sz, device=args.device)
    say = print if mesh is None or mesh.get_rank() == 0 else (lambda *a, **k: None)
    if args.ckpt_dir:
        step, state = restore_checkpoint(args.ckpt_dir, device=default_device(args.device))
        params = state["params"]
        say(f"serving the weights of step {step} from {args.ckpt_dir}")
    else:
        params = init_params(cfg, seed=args.seed, device=args.device)
    engine = ServeEngine(cfg, params, batch_size=args.batch, max_len=args.max_len, mesh=mesh)
    rng = np.random.default_rng(0)
    pending = [
        Request(i, rng.integers(0, cfg.vocab, size=rng.integers(4, 17)).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    done = []
    while pending:                       # wave-based batching
        wave, pending = pending[: args.batch], pending[args.batch:]
        done += engine.serve(wave)
    secs = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    say(f"served {len(done)} requests, {toks} tokens in {secs:.2f}s "
        f"({toks / secs:.1f} tok/s) on {engine.device if mesh is None else 'the mesh'}")
    for r in done[:4]:
        say(f"  req {r.request_id}: {r.output}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _parse_tenant_weights(specs: list[str] | None) -> dict[str, float]:
    if not specs:
        return {"alice": 2.0, "bob": 1.0}
    weights: dict[str, float] = {}
    for item in specs:
        name, _, w = item.partition("=")
        if not name or not w:
            raise SystemExit(f"--tenant-weight expects NAME=WEIGHT, got {item!r}")
        weights[name] = float(w)
    return weights


def run_search_service(args) -> int:
    import repro_torch.tabular  # noqa: F401  (registers the estimators)
    from repro_torch.core import SearchSpec
    from repro_torch.data.synthetic import make_higgs_like
    from repro_torch.device import default_device, set_default_device
    from repro_torch.launch.search import paper_search_space
    from repro_torch.serve import SearchService

    set_default_device(default_device(args.device or "cuda"))
    weights = _parse_tenant_weights(args.tenant_weight)
    data = make_higgs_like(args.rows, seed=0)
    train, valid = data.split((0.8, 0.2), seed=0)
    train, mu, sd = train.standardize()
    valid, _, _ = valid.standardize(mu, sd)
    budget = (int(args.cache_budget_mb * 1024 * 1024)
              if args.cache_budget_mb is not None else None)
    spec = SearchSpec(spaces=paper_search_space(args.scale),
                      n_executors=args.executors, max_tasks=args.max_tasks)
    svc = SearchService(n_executors=args.executors,
                        max_active=args.max_active,
                        max_queued=args.max_queued,
                        mode=args.scheduler,
                        artifact_root=args.artifact_root,
                        cache_budget_bytes=budget)
    t0 = time.perf_counter()
    try:
        handles = [svc.submit_search(spec, train, valid, tenant=t, weight=w)
                   for t, w in weights.items()]
        for h in handles:
            n_ok = sum(1 for r in h.results() if r.ok)
            best = h.multi_model().best(valid)
            print(f"[{h.tenant}/{h.session_id}] {n_ok} models, "
                  f"best {best.task.estimator} auc={best.score:.4f}, "
                  f"ttfr={h.time_to_first_result:.2f}s")
        print(f"\ntotal wall time {time.perf_counter() - t0:.2f}s "
              f"on {default_device()}")
        print(svc.stats().summary())
    finally:
        svc.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None,
                   help="LM architecture id (required unless --search-service)")
    p.add_argument("--smoke", action="store_true", help="the reduced config")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--mesh", default="1,1", help="data,model sizes")
    p.add_argument("--ckpt-dir", default=None, help="serve the newest checkpoint here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run on the CPU)")
    # -- multi-tenant search service (DESIGN.md §3.5) ----------------------
    p.add_argument("--search-service", action="store_true",
                   help="serve concurrent model searches instead of LM tokens")
    p.add_argument("--executors", type=int, default=4,
                   help="shared worker threads executing all tenants' units")
    p.add_argument("--max-active", type=int, default=8,
                   help="concurrent session slots; later submits queue")
    p.add_argument("--max-queued", type=int, default=None,
                   help="queued-session bound; beyond it submits are rejected")
    p.add_argument("--tenant-weight", action="append", metavar="NAME=W",
                   help="declare a tenant and its fair-share weight "
                        "(repeatable; default alice=2 bob=1)")
    p.add_argument("--cache-budget-mb", type=float, default=None,
                   help="byte budget for the shared prepared-data/compile "
                        "caches (LRU-evicted beyond it)")
    p.add_argument("--scheduler", choices=("fair_share", "fifo"),
                   default="fair_share")
    p.add_argument("--rows", type=int, default=2000)
    p.add_argument("--scale", type=float, default=0.2,
                   help="paper grid scale factor (CPU-friendly default)")
    p.add_argument("--max-tasks", type=int, default=12,
                   help="per-session task budget for the demo searches")
    p.add_argument("--artifact-root", default=None,
                   help="root for per-tenant WALs + the fleet cost model")
    args = p.parse_args(argv)
    if args.search_service:
        return run_search_service(args)
    if args.arch is None:
        p.error("--arch is required unless --search-service is given")
    return run_lm_serve(args)


if __name__ == "__main__":
    raise SystemExit(main())
