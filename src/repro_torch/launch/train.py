"""Training launcher of the port, on the GPU unless ``--device cpu`` is
given.  The flags are those of ``repro.launch.train``, plus ``--device``
and ``--kernel`` (attention through the Hopper flash-attention kernel; the
Mamba and RWKV scans stay plain, since their kernels have no backward):

    python -m repro_torch.launch.train --arch qwen3-8b --steps 100 --kernel
    python -m repro_torch.launch.train --device cpu --steps 3

``--smoke`` (the default) trains the reduced same-family config; full
configs want the card (``chip_smoke.py`` trains qwen3-8b at full width
with its depth cut).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS), default="gpt3-24l")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a GPU)")
    ap.add_argument("--kernel", action="store_true",
                    help="attention through the flash-attention kernel "
                         "(the Mamba and RWKV scans stay plain: their "
                         "kernels have no backward)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(steps=args.steps, lr=args.lr,
                       microbatches=args.microbatches,
                       ckpt_every=args.ckpt_every, seed=args.seed,
                       use_kernel=args.kernel, device=args.device)
    if args.ckpt_dir:
        tcfg.ckpt_dir = args.ckpt_dir
    loader = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, noise=args.noise,
        ext_embed_dim=cfg.ext_embed_dim, seed=args.seed), device=args.device)
    trainer = Trainer(cfg, tcfg, loader)
    if args.ckpt_every:
        trainer.maybe_restore()
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} on {trainer.device} (optimal loss ≈ "
          f"{loader.optimal_loss():.3f})")
    trainer.fit()


if __name__ == "__main__":
    main()
