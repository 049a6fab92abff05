"""LM serving launcher: the LM mode of the JAX package's ``launch/serve.py``.

    python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-7b           # on the card

It builds a ServeEngine on freshly initialised (seeded) weights and drives
a synthetic stream of requests through prefill + greedy decode in waves of
``--batch``, reporting tokens/s. It runs on the card unless ``--device cpu``
is given; without a card it raises. The reference's ``--search-service``,
``--mesh`` and ``--ckpt-dir`` are not ported yet (the multi-tenant search
service, sharding and checkpoints).
"""
from __future__ import annotations

import argparse
import time


def run_lm_serve(args) -> int:
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    params = init_params(cfg, seed=args.seed, device=args.device)
    engine = ServeEngine(cfg, params, batch_size=args.batch, max_len=args.max_len)
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
    print(f"served {len(done)} requests, {toks} tokens in {secs:.2f}s "
          f"({toks / secs:.1f} tok/s) on {params.embed.device}")
    for r in done[:4]:
        print(f"  req {r.request_id}: {r.output}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True, help="LM architecture id")
    p.add_argument("--smoke", action="store_true", help="the reduced config")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run on the CPU)")
    return run_lm_serve(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
