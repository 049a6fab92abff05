"""Batched LM serving example: request waves through prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma_2b --requests 8 --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma_2b   # on the card
"""
import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import count_params, init_params
from repro_torch.serve import Request, ServeEngine


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="gemma_2b")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--new-tokens", type=int, default=12)
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = p.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch)
    params = init_params(cfg, seed=0, device=args.device)
    print(f"serving {cfg.name} ({count_params(params)/1e6:.1f}M params), "
          f"batch={args.batch}")
    engine = ServeEngine(cfg, params, batch_size=args.batch, max_len=128)

    rng = np.random.default_rng(0)
    pending = [
        Request(i, rng.integers(0, cfg.vocab, rng.integers(4, 20)).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    done = []
    while pending:
        wave, pending = pending[: args.batch], pending[args.batch:]
        done += engine.serve(wave)
    secs = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    print(f"{len(done)} requests, {total} tokens, {secs:.2f}s "
          f"→ {total/secs:.1f} tok/s")
    for r in done[:4]:
        print(f"  request {r.request_id} ({len(r.prompt)} prompt tokens) "
              f"→ {r.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
