"""End-to-end LM training driver on the port's stack.

Trains a transformer with the full substrate — the TrainState in the JAX
package's tree layout, chunked CE loss, checkpoint/restart, prefetching
pipeline — and prints the loss curve. Default is a CPU-friendly ~3M-param
model for a few hundred steps; ``--preset 100m`` selects a ~100M-param
config (the assignment's example scale):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.data.pipeline import make_lm_stream
from repro_torch.models import ArchConfig, LayerSpec, count_params, init_params
from repro_torch.train import Trainer, make_optimizer


def preset_100m() -> ArchConfig:
    return ArchConfig(
        name="repro-100m",
        vocab=32000, d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
        d_ff=2560, pattern=(LayerSpec(kind="attn"),), repeats=12,
        ffn_act="swiglu", norm="rmsnorm", tie_embeddings=True, loss_chunk=128,
    )


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="smoke", choices=("smoke", "100m"))
    p.add_argument("--arch", default="tinyllama_1_1b",
                   help="smoke-config family to use with --preset smoke")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_lm"))
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = p.parse_args(argv)

    cfg = preset_100m() if args.preset == "100m" else configs.get_smoke_config(args.arch)
    cfg = dataclasses.replace(cfg, loss_chunk=min(cfg.loss_chunk, args.seq_len))
    n = count_params(init_params(cfg, device="meta"))
    print(f"model {cfg.name}: {n / 1e6:.1f}M params, {cfg.n_layers} layers")
    stream = make_lm_stream(args.batch, args.seq_len, cfg.vocab, device=args.device)
    trainer = Trainer(cfg, make_optimizer("adamw", lr=3e-3), stream,
                      ckpt_dir=args.ckpt_dir, ckpt_every=100, device=args.device)
    start = trainer.init_or_restore()
    print(f"starting from step {start}")
    metrics = trainer.run(args.steps)
    hist = metrics.history
    for h in hist[:: max(1, len(hist) // 15)]:
        print(f"  step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"{h['seconds']*1e3:6.0f} ms/step")
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} (from {hist[0]['loss']:.4f})")
    stream.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
