"""Training launcher, the JAX package's ``launch/train.py``:

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu
    python -m repro_torch.launch.train --arch tinyllama-1.1b --batch 4 --seq-len 2048

Runs a training job with the full stack: a seeded TrainState, the chunked
CE loss, checkpoint/restart and the prefetching data pipeline. It runs on
the card unless ``--device cpu`` is given; without a card it raises.
``--resume`` is implicit: with ``--ckpt-dir`` holding checkpoints the run
continues from the newest. The flags are the reference's, plus
``--device``.

``--mesh data,model`` other than ``1,1`` (or ``--dp-mode
shard_map_int8``) trains over a device mesh, one rank per entry, launched
by ``torchrun``: one card per rank on NCCL, or gloo with ``--device cpu``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --device cpu --mesh 2,2 --steps 10 --batch 8 --seq-len 32
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch tinyllama-1.1b \
        --mesh 4,2 --batch 8 --seq-len 2048

Rank 0 prints; a mesh checkpoint is written whole by rank 0 and restores
on any mesh or on one device.
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

    data_sz, model_sz = (int(x) for x in args.mesh.split(","))
    mesh = None
    if (data_sz, model_sz) != (1, 1) or args.dp_mode == "shard_map_int8":
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(data=data_sz, model=model_sz, device=args.device)
    say = print if mesh is None or mesh.get_rank() == 0 else (lambda *a, **k: None)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    stream = make_lm_stream(args.batch, args.seq_len, cfg.vocab, seed=args.seed,
                            extras=_stub_extras(cfg, args.batch), device=args.device,
                            mesh=mesh)
    opt = make_optimizer(args.optimizer, lr=args.lr)
    trainer = Trainer(cfg, opt, stream, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, dp_mode=args.dp_mode, device=args.device,
                      mesh=mesh)
    start = trainer.init_or_restore(seed=args.seed)
    where = trainer.device if mesh is None else f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    say(f"training {cfg.name} from step {start} on {where}")
    metrics = trainer.run(args.steps)
    for h in metrics.history[:: max(1, len(metrics.history) // 20)]:
        say(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f} {h['seconds']*1e3:.0f}ms")
    stream.close()
    final = metrics.history[-1]["loss"] if metrics.history else float("nan")
    say(f"done: final loss {final:.4f}  nan_skips={metrics.nan_skips} "
        f"retries={metrics.retries} restores={metrics.restores}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
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
