"""Quickstart: build a small decoder from the public API, train it on the
synthetic stream until the loss approaches the analytic optimum, then
generate from it, and check that the generation follows the stream's
hash rule.  The PyTorch port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py              # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM, _hash_next
from repro_torch.serve.engine import generate
from repro_torch.train.trainer import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # any assigned architecture works here; qwen3-8b's reduced variant is a
    # 2-layer GQA decoder with qk-norm
    cfg = get_smoke_config("qwen3-8b")
    cfg = dataclasses.replace(cfg, vocab_size=128)

    loader = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, noise=0.05),
        device=device)
    print(f"model: {cfg.name}  ({cfg.n_layers}L, d={cfg.d_model})  on "
          f"{device}")
    print(f"optimal loss of the stream ≈ {loader.optimal_loss():.3f}")

    trainer = Trainer(cfg, TrainConfig(steps=80, lr=3e-3, warmup=10,
                                       log_every=20, device=str(device)),
                      loader)
    trainer.fit()

    prompts = loader.batch(999)["tokens"][:2, :8]
    out = generate(trainer.params, cfg, prompts, max_new=12)
    print("prompt     :", prompts[0].tolist())
    print("generated  :", out[0, 8:].tolist())
    # the stream is t+1 = hash(t) 95% of the time; check the model learned it
    pred = out[0, 8:].tolist()
    hits = sum(int(pred[i + 1] == _hash_next(pred[i], cfg.vocab_size))
               for i in range(len(pred) - 1))
    print(f"hash-rule hits in generation: {hits}/{len(pred)-1}")
    assert 2 * hits > len(pred) - 1, "the model did not learn the hash rule"


if __name__ == "__main__":
    main()
