"""End-to-end training: train a ~100M-parameter decoder for a few
hundred steps with checkpointing and resume.  The PyTorch port of
``examples/train_e2e.py``.

    PYTHONPATH=src python examples_torch/train_e2e.py --preset 100m --steps 300
    PYTHONPATH=src python examples_torch/train_e2e.py --preset 20m  --steps 150
    PYTHONPATH=src python examples_torch/train_e2e.py --preset 3m --steps 6 \
        --device cpu

The 100m preset is the deliverable configuration (sized for the card);
the 20m and 3m presets run the identical path on smaller budgets.  The
loss should approach the stream's analytic optimum.  Checkpoints use the
JAX package's format, so ``--resume`` also picks up a checkpoint that
``examples/train_e2e.py`` wrote.
"""
import argparse
import math
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.train.trainer import TrainConfig, Trainer

PRESETS = {
    # ~103M params: 12L, d=768, vocab 32k (GPT-2-small-like)
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                 head_dim=64, d_ff=3072, vocab_size=32000,
                 seq=512, batch=8),
    # ~19M params
    "20m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=6,
                head_dim=64, d_ff=1536, vocab_size=8192,
                seq=256, batch=8),
    # ~3M: smoke
    "3m": dict(n_layers=4, d_model=192, n_heads=4, n_kv_heads=4,
               head_dim=48, d_ff=768, vocab_size=2048,
               seq=128, batch=8),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="20m")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    p = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"e2e-{args.preset}", arch_type="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"])
    print(f"{cfg.name}: {cfg.param_counts()['total']/1e6:.1f}M params "
          f"on {device}")

    loader = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=p["seq"], global_batch=p["batch"],
        noise=0.05), device=device)
    print(f"optimal loss ≈ {loader.optimal_loss():.3f}")
    trainer = Trainer(cfg, TrainConfig(
        steps=args.steps, lr=args.lr, warmup=max(10, args.steps // 20),
        log_every=max(1, args.steps // 20), ckpt_every=args.steps // 3,
        ckpt_dir=args.ckpt_dir, device=str(device)), loader)
    if args.resume:
        trainer.maybe_restore()
        print(f"resumed at step {trainer.start_step}")
    hist = trainer.fit()
    assert math.isfinite(hist[-1]["loss"]), hist[-1]
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(optimum {loader.optimal_loss():.3f}); "
          f"checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
