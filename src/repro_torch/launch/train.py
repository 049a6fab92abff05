"""Training launcher, the JAX package's ``launch/train.py``:

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu
    python -m repro_torch.launch.train --arch tinyllama-1.1b --batch 4 --seq-len 2048

Runs a training job with the full stack on one device: a seeded TrainState,
the chunked CE loss, checkpoint/restart and the prefetching data pipeline.
It runs on the card unless ``--device cpu`` is given; without a card it
raises. ``--resume`` is implicit: with ``--ckpt-dir`` holding checkpoints
the run continues from the newest. The flags are the reference's, plus
``--device``; ``--mesh`` other than ``1,1`` and ``--dp-mode
shard_map_int8`` raise NotImplementedError (ROADMAP Queue 1 items 5–6).
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw")
    p.add_argument("--mesh", default="1,1", help="data,model sizes")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--dp-mode", default="gspmd", choices=("gspmd", "shard_map_int8"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = p.parse_args(argv)

    from repro_torch import configs
    from repro_torch.data.pipeline import make_lm_stream
    from repro_torch.train import Trainer, make_optimizer

    if tuple(int(x) for x in args.mesh.split(",")) != (1, 1):
        raise NotImplementedError(f"--mesh {args.mesh}: training over a mesh is not "
                                  "ported yet (ROADMAP Queue 1 items 5-6)")
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    stream = make_lm_stream(args.batch, args.seq_len, cfg.vocab, seed=args.seed,
                            extras=_stub_extras(cfg, args.batch), device=args.device)
    opt = make_optimizer(args.optimizer, lr=args.lr)
    trainer = Trainer(cfg, opt, stream, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, dp_mode=args.dp_mode, device=args.device)
    start = trainer.init_or_restore(seed=args.seed)
    print(f"training {cfg.name} from step {start} on {trainer.device}")
    metrics = trainer.run(args.steps)
    for h in metrics.history[:: max(1, len(metrics.history) // 20)]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f} {h['seconds']*1e3:.0f}ms")
    stream.close()
    final = metrics.history[-1]["loss"] if metrics.history else float("nan")
    print(f"done: final loss {final:.4f}  nan_skips={metrics.nan_skips} "
          f"retries={metrics.retries} restores={metrics.restores}")
    return 0


def _stub_extras(cfg, batch):
    extras = {}
    if cfg.frontend == "audio_stub":
        extras["enc_embeds"] = ((batch, cfg.encoder_seq, cfg.d_model), "float32")
    if cfg.frontend == "vision_stub":
        extras["patch_embeds"] = ((batch, cfg.num_patches, cfg.d_model), "float32")
    return extras or None


if __name__ == "__main__":
    raise SystemExit(main())
