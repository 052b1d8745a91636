"""Sharding hints: a context that lets deep model internals (the cache
writes, MoE dispatch) pin the layout of an intermediate without
threading mesh plumbing through every call — the port's
``repro.models.hints``.  No context -> every hint returns its input
untouched (the served and trained paths on one card, and every
single-device test).

The launch layer activates hints around a step (``use_hints`` /
``wrap_with_hints``); the rules are ``repro_torch.launch.shardings``'s.
Where a context is set, ``constrain`` redistributes a ``DTensor`` to the
rule's placements (JAX's ``with_sharding_constraint``); a plain tensor
passes through.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_hints", default=None)
_TRIPS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_trip_count", default=1)


class HintContext:
    def __init__(self, mesh, rule: Callable, extras: Optional[dict] = None):
        self.mesh = mesh
        self.rule = rule
        self.extras = extras or {}


@contextlib.contextmanager
def use_hints(mesh, rule, **extras):
    """rule(kind: str, shape: tuple) -> spec | None.
    extras: scalar knobs model code may read (e.g. moe_groups)."""
    tok = _CTX.set(HintContext(mesh, rule, extras))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current() -> Optional[HintContext]:
    """The active context (None without one), for ``restored``."""
    return _CTX.get()


@contextlib.contextmanager
def restored(ctx: Optional[HintContext]):
    """Make ``ctx`` (from ``current``) the active context: a remat
    recompute runs inside the backward pass, on an autograd thread where
    the forward's context is not set."""
    tok = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(tok)


def get_extra(key: str, default=None):
    ctx = _CTX.get()
    return default if ctx is None else ctx.extras.get(key, default)


def get_mesh():
    ctx = _CTX.get()
    return None if ctx is None else ctx.mesh


def constrain(x, kind: str):
    """Redistribute a DTensor ``x`` to the active rule's layout for
    ``kind``; ``x`` itself without a context, for a plain tensor, or where
    the rule has no entry."""
    ctx = _CTX.get()
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = ctx.rule(kind, tuple(x.shape))
    if spec is None:
        return x
    from repro_torch.launch.shardings import sanitize_spec, to_placements
    placements = to_placements(sanitize_spec(spec, tuple(x.shape), ctx.mesh),
                               ctx.mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(ctx.mesh, placements)


def wrap_with_hints(fn, mesh, rule, **extras):
    """Return fn wrapped so hints are active while it runs."""
    def wrapped(*a, **kw):
        with use_hints(mesh, rule, **extras):
            return fn(*a, **kw)
    return wrapped


def reshape(x, *shape):
    """``x.reshape(*shape)``.  For a DTensor, a reshape that would split a
    sharded dim unevenly (8 kv heads of a dim sharded 16 ways) or leave a
    strided shard (merging heads sharded on their inner dim) first
    replicates the input's sharded mesh dims — the re-shard GSPMD inserts
    for the JAX package's reshape — and its gradient is reshaped back the
    same way."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _sharded_reshape(x, shape):
    """Reshape a DTensor after replicating the mesh dims whose shard the
    new shape cannot keep whole: a shard survives a reshape only on the
    outermost dim of a group of dims that are merged or split, and only
    where that dim and the group's outermost new dim divide evenly.  Decided
    from shapes alone, so a remat recompute takes the same path."""
    from torch.distributed.tensor import Replicate, Shard
    shape = _full_shape(tuple(x.shape), shape)
    groups = _dim_groups(tuple(x.shape), shape)
    keep = list(x.placements)
    for i, p in enumerate(x.placements):
        if not isinstance(p, Shard):
            continue
        src, dst = next(g for g in groups if p.dim in g[0])
        n = math.prod(x.device_mesh.size(j) for j, q in
                      enumerate(x.placements)
                      if isinstance(q, Shard) and q.dim == p.dim)
        if (p.dim != src[0] or not dst or shape[dst[0]] % n
                or x.shape[p.dim] % n):
            keep[i] = Replicate()
    if keep != list(x.placements):
        x = x.redistribute(x.device_mesh, keep)
    return x.reshape(*shape)


def _full_shape(old, shape):
    """``shape`` with a -1 resolved."""
    if -1 not in shape:
        return tuple(shape)
    known = math.prod(d for d in shape if d != -1)
    return tuple(math.prod(old) // known if d == -1 else d for d in shape)


def _dim_groups(old, new):
    """[(old dims, new dims)]: the smallest runs of dims whose sizes have
    equal products (size-1 dims join the run before them)."""
    groups, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        a, b = [i], [j] if j < len(new) else []
        pa = old[i] if i < len(old) else 1
        pb = new[j] if j < len(new) else 1
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                a.append(i)
                pa *= old[i]
                i += 1
            else:
                b.append(j)
                pb *= new[j]
                j += 1
        while i < len(old) and old[i] == 1 and (j >= len(new) or
                                                new[j] != 1):
            a.append(i)
            i += 1
        groups.append(([d for d in a if d < len(old)], b))
    return groups


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _sharded_reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _sharded_reshape(g, ctx.in_shape), None


def unsplit(x, dim: int):
    """A DTensor ``x`` with tensor dim ``dim`` whole on every rank (the
    mesh dims that split it replicate); a plain tensor as it is.  For an
    op that reduces over ``dim`` to an index (an argmax over sharded
    logits)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim
                  else p for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def splits_alike(x, dx: int, w, dw: int) -> bool:
    """Whether DTensors ``x`` and ``w`` are split over the same mesh dims
    along their dims ``dx`` and ``dw``, and along no other dim there (a
    contraction of the two stays on each rank).  False for plain
    tensors."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return False
    dx, dw = dx % x.ndim, dw % w.ndim
    for p, q in zip(x.placements, w.placements):
        a = p.dim == dx if isinstance(p, Shard) else None
        b = q.dim == dw if isinstance(q, Shard) else None
        if a != b:
            return False
    return True


# ---------------------------------------------------------------------------
# Local computation on DTensor shards (the port's ``shard_map``): a layer
# op with no sharding rule of its own — chunked attention, a recurrence,
# the cross entropy — runs unchanged on each rank's shard, between an
# explicit redistribution of its inputs and a re-wrap of its outputs.
# ---------------------------------------------------------------------------

def mesh_of(*xs):
    """The device mesh of the first DTensor among ``xs``, or None."""
    from torch.distributed.tensor import DTensor
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def to_local(x, mesh, placements, split=()):
    """``x`` (a DTensor, or a plain tensor taken as replicated) laid out
    as ``placements`` over ``mesh``; returns this rank's shard.  ``split``
    names the mesh dims over which the local computation divides its work
    (its outputs are sharded there): a replicated input's gradient is
    partial over those dims (each rank's share of it), as a replicated
    input's cotangent is summed in JAX's ``shard_map``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if x is None:
        return None
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh, placements)
    grad = [Partial() if i in split and isinstance(p, Replicate) else p
            for i, p in enumerate(placements)]
    return x.to_local(grad_placements=grad)


def from_local(x, mesh, placements, shape):
    """A rank's shard ``x`` as the DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(stride)))


# ---------------------------------------------------------------------------
# Layouts of the layer ops that run on each rank's shard: one table for the
# plain versions and the kernels' custom ops alike, so that a dry-run with
# the kernels and one without trace the same plan (the custom ops have no
# DTensor rule of their own: called on DTensors, they raise).  Per op kind:
# its lead arguments, whose layout decides, per split mode the placement
# of each argument and result by name, and the modes that fit only some
# shapes.  A mesh dim follows the first lead argument it splits in one of
# the modes' ways, where every argument that mode splits divides evenly
# and the mode fits; any other mesh dim runs the op whole (replicated).
# ---------------------------------------------------------------------------

_R, _S0, _S1, _S2, _S3 = (Replicate(), Shard(0), Shard(1), Shard(2),
                          Shard(3))
_HEADS = dict(q=_S2, k=_S2, v=_S2, q_pos=_R, kv_pos=_R, table=_R,
              q_extra=_S2, k_extra=_S2, out=_S2)
LAYOUTS = {
    # attention over dense (B, T, ...) caches: kv heads (whole GQA groups)
    # or slots split, or the head dims ("dims": each rank's scores are a
    # partial sum over its slice of D, completed by an all-reduce before
    # the softmax, and its output is its slice of Dv — the layout of a
    # cache whose kv heads do not divide the model axis)
    "attention": (("q", "k"), {
        "heads": _HEADS,
        "slots": dict(q=_S0, k=_S0, v=_S0, q_pos=_S0, kv_pos=_S0, table=_R,
                      q_extra=_S0, k_extra=_S0, out=_S0),
        "dims": dict(q=_S3, k=_S3, v=_S3, q_pos=_R, kv_pos=_R, table=_R,
                     q_extra=_S3, k_extra=_S3, out=_S3)},
        # the float32 scores it all-reduces must be fewer bytes than the
        # keys and values running whole would gather: decode, not prefill
        {"dims": lambda a: (a["q"].shape[1] * a["q"].shape[2] * 4
                            < a["k"].shape[2] * (a["k"].shape[3]
                                                 + a["v"].shape[3])
                            * a["k"].element_size())}),
    # over block pools: a slot-split rank holds whole pools (the table's
    # block ids are global), so a block-split pool is gathered there; no
    # "dims" mode, since the kernel takes whole head dims
    "paged_attention": (("q", "k", "table"), {
        "heads": _HEADS,
        "slots": dict(q=_S0, k=_R, v=_R, q_pos=_S0, kv_pos=_R, table=_S0,
                      q_extra=_S0, k_extra=_R, out=_S0)}),
    # the selective scan: slots, or inner channels (b / c are shared by
    # every channel)
    "mamba_scan": (("x",), {
        "channels": dict(x=_S2, dt=_S2, b=_R, c=_R, a=_S0, h0=_S1, rows=_R,
                         y=_S2, h=_S1),
        "slots": dict(x=_S0, dt=_S0, b=_S0, c=_S0, a=_R, h0=_S0, rows=_S0,
                      y=_S0, h=_S0)}),
    # the wkv recurrence: heads or slots (independent per slot and head)
    "rwkv_scan": (("r",), {
        "heads": dict(r=_S2, k=_S2, v=_S2, w=_S2, u=_S0, s0=_S1, rows=_R,
                      o=_S2, s=_S1),
        "slots": dict(r=_S0, k=_S0, v=_S0, w=_S0, u=_R, s0=_S0, rows=_S0,
                      o=_S0, s=_S0)}),
}


def plan(kind: str, mesh, args: dict) -> list:
    """Per mesh dim, op ``kind``'s split mode (None: whole), from its
    DTensor ``args`` ({name: tensor or None})."""
    leads, modes, *rest = LAYOUTS[kind]
    fits = rest[0] if rest else {}
    chosen: list = []

    def even(lay, i) -> bool:
        for name, t in args.items():
            pl = lay[name]
            if t is None or not isinstance(pl, Shard):
                continue
            n = mesh.size(i) * math.prod(
                mesh.size(j) for j, m in enumerate(chosen)
                if m and modes[m][name] == pl)
            if t.shape[pl.dim] % n:
                return False
        return True

    for i in range(mesh.ndim):
        pick = None
        for name in leads:
            t = args.get(name)
            pl = t.placements[i] if isinstance(t, DTensor) else None
            if isinstance(pl, Shard):
                pick = next((m for m, lay in modes.items()
                             if lay[name] == pl and even(lay, i)
                             and fits.get(m, lambda a: True)(args)), None)
            if pick:
                break
        chosen.append(pick)
    return chosen


def local_call(kind: str, fn: Callable, args: dict, shapes: dict):
    """``fn(groups, **args)`` run on each rank's shard of op ``kind``'s
    arguments, laid out by its plan (the port's ``shard_map``); ``groups``
    is {split mode: [process groups of the mesh dims split that way]}.
    ``shapes``: {result name: global shape}, in the order of fn's
    results.  Returns the results as DTensors: one, or a tuple (a None
    result stays None)."""
    mesh = mesh_of(*args.values())
    modes = plan(kind, mesh, args)
    table = LAYOUTS[kind][1]
    at = lambda name: [table[m][name] if m else _R for m in modes]
    split = [i for i, m in enumerate(modes) if m]
    groups: dict = {}
    for i, m in enumerate(modes):
        if m:
            groups.setdefault(m, []).append(mesh.get_group(i))
    outs = fn(groups, **{k: to_local(v, mesh, at(k), split)
                         for k, v in args.items()})
    outs = outs if len(shapes) > 1 else (outs,)
    res = tuple(None if o is None else from_local(o, mesh, at(n), shape)
                for o, (n, shape) in zip(outs, shapes.items()))
    return res if len(shapes) > 1 else res[0]


class _AllSum(torch.autograd.Function):
    """All-reduce sum over ``groups`` into a value every rank of them then
    holds alike: each rank's gradient is the incoming one, unchanged."""

    @staticmethod
    def forward(ctx, x, groups):
        from torch.distributed import _functional_collectives as funcol
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_sum(x, groups):
    """``x`` summed over the ranks of every process group in ``groups``
    (differentiable; ``x`` itself for none)."""
    return _AllSum.apply(x, list(groups)) if groups else x


def scan_steps(fn: Callable, args: dict, over: tuple):
    """``fn(**args)`` for a recurrence over dim 1 of the ``over``
    arguments; its results are (per-step output, final state).  On fake
    tensors (a dry-run, where only shapes and counts matter) two time
    steps stand for all S: they are traced once and counted S // 2 times
    (``repeat``), and the output is broadcast back to S steps."""
    from torch._subclasses.fake_tensor import is_fake
    S = args[over[0]].shape[1]
    if S <= 2 or not is_fake(args[over[0]]):
        return fn(**args)
    with repeat(S // 2):
        y, state = fn(**{k: v[:, :2] if k in over else v
                         for k, v in args.items()})
    return (y[:, :1].expand(-1, S, *y.shape[2:])
            + y[:, 1:].sum(1, keepdim=True)), state


@contextlib.contextmanager
def repeat(n: int):
    """The ops traced inside stand for ``n`` repetitions of themselves: a
    dry-run traces one step of a long time loop on fake tensors and its
    counters (``launch/roofline.py``) count it ``n`` times — the JAX
    package's trip-count multiplication of a while-loop body."""
    tok = _TRIPS.set(_TRIPS.get() * n)
    try:
        yield
    finally:
        _TRIPS.reset(tok)


def trips() -> int:
    return _TRIPS.get()
