"""Trainer: the end-to-end loop tying the data pipeline, train step,
checkpointing and logging together — the counterpart of
``repro.train.trainer``, on the device the config names (cuda unless
"cpu" is asked for)."""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params, trainable
from repro_torch.optim.adamw import adamw, cosine_lr
from repro_torch.train.step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.01
    microbatches: int = 1
    remat: bool = True
    log_every: int = 10
    ckpt_every: int = 0                 # 0 = disabled
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    seed: int = 0
    # attention through the flash kernel; the Mamba and RWKV scans stay
    # plain (their kernels have no backward)
    use_kernel: bool = False
    device: Optional[str] = None        # None = cuda


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 loader: SyntheticLM):
        self.cfg = cfg
        self.tcfg = tcfg
        self.loader = loader
        self.device = resolve_device(tcfg.device)
        self.optimizer = adamw(
            cosine_lr(tcfg.lr, tcfg.warmup, tcfg.steps),
            weight_decay=tcfg.weight_decay)
        self.params = trainable(init_params(tcfg.seed, cfg,
                                            device=self.device))
        self.opt_state = self.optimizer.init(self.params)
        self.step_fn = make_train_step(
            cfg, self.optimizer, microbatches=tcfg.microbatches,
            remat=tcfg.remat, use_kernel=tcfg.use_kernel)
        self.history: List[Dict[str, float]] = []
        self.start_step = 0

    def maybe_restore(self) -> None:
        latest = store.latest_step(self.tcfg.ckpt_dir)
        if latest is not None:
            (params, self.opt_state), step = store.restore(
                self.tcfg.ckpt_dir, (self.params, self.opt_state))
            self.params = trainable(params)
            self.start_step = step

    def fit(self, log: Callable[[str], None] = print) -> List[Dict[str, float]]:
        t0 = time.time()
        for step in range(self.start_step, self.tcfg.steps):
            batch = {k: v.to(self.device)
                     for k, v in self.loader.batch(step).items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = time.time() - t0
                self.history.append(m)
                log(f"step {step:5d}  loss {m['loss']:.4f}  ce {m['ce']:.4f}  "
                    f"acc {m['acc']:.3f}  gnorm {m['grad_norm']:.2f}  "
                    f"lr {m['lr']:.2e}  [{m['wall_s']:.1f}s]")
            if self.tcfg.ckpt_every and (step + 1) % self.tcfg.ckpt_every == 0:
                store.save(self.tcfg.ckpt_dir, step + 1,
                           (self.params, self.opt_state))
        return self.history
