"""Plain float32 reference of the decoder the benchmark trains: GQA
attention with per-head qk-norm (Qwen3), dense SwiGLU FFNs, RMSNorm,
rotary embeddings, the unembedding, the cross entropy and AdamW.

It imports only torch and reads only what the benchmark hands it: the
configuration's ``port`` section, weights by path (made by the
benchmark from the seed; any dtype, upcast to float32 where used),
tokens and labels.  Matmuls run in float32 with TF32 off.  The
equations follow the published descriptions with these departures,
which are the configuration as run:

* RMSNorm scales are stored minus one (``x * rsqrt(mean(x^2) + eps) *
  (1 + scale)``);
* rotary embedding over the two halves of a head's dims (Qwen3's
  ``rotate_half``), not interleaved pairs.

``lowp=True`` is the control: every matmul's operands (weights and
activations, the attention products included) rounded to float8 e4m3
with one scale per tensor, the gradient passed straight through; the
rest stays float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor; the gradient
    passes straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach() if x.requires_grad else q


def mm(a: torch.Tensor, b: torch.Tensor, lowp: bool) -> torch.Tensor:
    if lowp:
        a, b = fp8(a), fp8(b)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), pos (S,): rotation of the two halves of D."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = pos[:, None].float() * freq                       # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, scale, lowp):
    """q (B, S, h, D) against k (B, T, h, D), v (B, T, h, Dv): causal,
    the queries at the last S of T positions."""
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", fp8(q) if lowp else q,
                     fp8(k) if lowp else k) * scale
    i = torch.arange(S, device=q.device)[:, None] + (T - S)
    j = torch.arange(T, device=q.device)[None, :]
    s = s.masked_fill(j > i, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", fp8(p) if lowp else p,
                        fp8(v) if lowp else v)


def attention(q, k, v, scale, lowp, heads_per_block: int = 8):
    """Causal attention in blocks of heads (each block recomputed in the
    backward pass when autograd records); k / v have Hkv heads, query
    head h reads kv head h // (Hq // Hkv)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    G = Hq // Hkv
    outs = []
    for h0 in range(0, Hq, heads_per_block):
        h1 = min(Hq, h0 + heads_per_block)
        kv = torch.arange(h0, h1, device=q.device) // G
        args = (q[:, :, h0:h1], k[:, :, kv], v[:, :, kv])
        if torch.is_grad_enabled() and q.requires_grad:
            outs.append(checkpoint(_attend, *args, scale, lowp,
                                   use_reentrant=False))
        else:
            outs.append(_attend(*args, scale, lowp))
    return torch.cat(outs, dim=2)


class Weights:
    """Weights by path, read as float32 (a stacked leaf's period ``t``)."""

    def __init__(self, get: Callable[[str], torch.Tensor]):
        self.get = get

    def __call__(self, path: str, t: Optional[int] = None) -> torch.Tensor:
        w = self.get(path)
        if t is not None:
            w = w[t]
        return w.float()


def gqa(W, pre, t, cfg, x, pos, lowp):
    B, S, _ = x.shape
    H, Hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm(x, W(f"{pre}/mixer/wq", t), lowp).view(B, S, H, hd)
    k = mm(x, W(f"{pre}/mixer/wk", t), lowp).view(B, S, Hkv, hd)
    v = mm(x, W(f"{pre}/mixer/wv", t), lowp).view(B, S, Hkv, hd)
    if cfg.get("qk_norm"):
        q = rmsnorm(q, W(f"{pre}/mixer/q_norm", t), cfg["norm_eps"])
        k = rmsnorm(k, W(f"{pre}/mixer/k_norm", t), cfg["norm_eps"])
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = attention(q, k, v, hd ** -0.5, lowp)
    return mm(o.reshape(B, S, H * hd), W(f"{pre}/mixer/wo", t), lowp)


def swiglu(x, wg, wu, wd, lowp):
    g = mm(x, wg, lowp)
    return mm(g * torch.sigmoid(g) * mm(x, wu, lowp), wd, lowp)


def layers(cfg) -> List[tuple]:
    """(path prefix, period index or None) of every layer in order."""
    prefix = cfg.get("prefix_layers", [])
    out = [(f"prefix/{i}", None) for i in range(len(prefix))]
    period = cfg["period"]
    n_periods = (cfg["n_layers"] - len(prefix)) // len(period)
    for t in range(n_periods):
        out += [(f"stack/{j}", t) for j in range(len(period))]
    return out


def block(W, pre, t, cfg, x, pos, lowp):
    eps = cfg["norm_eps"]
    h = rmsnorm(x, W(f"{pre}/norm1", t), eps)
    x = x + gqa(W, pre, t, cfg, h, pos, lowp)
    h = rmsnorm(x, W(f"{pre}/norm2", t), eps)
    return x + swiglu(h, W(f"{pre}/ffn/w_gate", t), W(f"{pre}/ffn/w_up", t),
                      W(f"{pre}/ffn/w_down", t), lowp)


def hidden(W: Weights, cfg: dict, tokens: torch.Tensor, *,
           lowp: bool = False) -> torch.Tensor:
    """Final-normed hidden states (B, S, d) of (B, S) tokens at positions
    0 .. S - 1, each layer recomputed in the backward pass."""
    x = W("embed")[tokens.long()]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for pre, t in layers(cfg):
        x = checkpoint(block, W, pre, t, cfg, x, pos, lowp,
                       use_reentrant=False)
    return rmsnorm(x, W("final_norm"), cfg["norm_eps"])


def head(W: Weights, cfg: dict) -> torch.Tensor:
    return W("embed").T if cfg.get("tie_embeddings") else W("lm_head")


def _nll_sum(h, w, labels, lowp):
    logits = mm(h, w, lowp)
    return (torch.logsumexp(logits, -1)
            - logits.gather(1, labels[:, None].long())[:, 0]).sum()


def loss(W: Weights, cfg: dict, tokens, labels, *, lowp: bool = False,
         chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy, the unembedding in row chunks
    (recomputed in the backward pass)."""
    h = hidden(W, cfg, tokens, lowp=lowp)
    d = h.shape[-1]
    hf, lf = h.reshape(-1, d), labels.reshape(-1)
    w = head(W, cfg)
    total = 0.0
    for i in range(0, hf.shape[0], chunk):
        total = total + checkpoint(_nll_sum, hf[i:i + chunk], w,
                                   lf[i:i + chunk], lowp, use_reentrant=False)
    return total / hf.shape[0]


def cosine_lr(step: int, peak: float, warmup: int, total: int,
              floor: float = 0.0) -> float:
    if step < warmup:
        return peak * step / max(1, warmup)
    t = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
    return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * t))


def train(leaves: Dict[str, torch.Tensor], cfg: dict, batches: Sequence,
          opt: dict, *, lowp: bool = False, half_batch: bool = False) -> dict:
    """AdamW steps over ``batches`` ((tokens, labels) pairs) from the
    float32 ``leaves`` (updated in place): global-norm clipping, bias
    correction, decoupled weight decay, the cosine schedule.  Returns
    {"losses", "grad1": per-leaf norm of step 1's clipped gradient}.
    ``half_batch``: the fault that leaves half of each batch out."""
    no_tf32()
    names = list(leaves)
    for n in names:
        leaves[n].requires_grad_(True)
    W = Weights(leaves.__getitem__)
    mu = {n: torch.zeros_like(leaves[n]) for n in names}
    nu = {n: torch.zeros_like(leaves[n]) for n in names}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, grad1 = [], {}
    for k, (tokens, labels) in enumerate(batches):
        if half_batch:
            tokens, labels = tokens[: len(tokens) // 2], labels[: len(labels) // 2]
        L = loss(W, cfg, tokens, labels, lowp=lowp)
        grads = torch.autograd.grad(L, [leaves[n] for n in names])
        losses.append(float(L.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = min(1.0, opt["clip_norm"] / max(float(norm), 1e-12))
            step = k + 1
            lr = cosine_lr(step, opt["lr"], opt["warmup"], opt["total"])
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for n, g in zip(names, grads):
                g = g * scale
                if k == 0:
                    grad1[n] = float(g.norm())
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).add_(g.square(), alpha=1 - b2)
                u = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
                p = leaves[n]
                p.sub_(lr * (u + opt["weight_decay"] * p))
        del grads
    for n in names:
        leaves[n].requires_grad_(False)
    return {"losses": losses, "grad1": grad1}

