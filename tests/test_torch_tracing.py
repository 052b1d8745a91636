"""The port's span recorder (``repro_torch.tracing``) on one training step
of a tiny qwen3 (2 layers, S 32, full remat, the flash path, which runs
its plain version on the CPU).

With the profiler off a step records nothing and ``span`` returns the
shared null context.  Under ``torch.profiler`` the step records its
phases and each attention call, with their parents: the remat's
recompute puts two of the four ``attn.forward`` spans under
``train.backward``.  Spans change no number of the step.
"""
import itertools
import threading

import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import init_params, trainable  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

CFG = get_smoke_config("qwen3-8b")
PHASES = ("train.forward", "train.backward", "train.optimizer")


def _one_step(profiled: bool):
    """(params, loss) after one step from fresh weights, and the
    profiler's event names when ``profiled``."""
    params = trainable(init_params(0, CFG, device="cpu"))
    opt = adamw(1e-3, weight_decay=0.01)
    state = opt.init(params)
    step = make_train_step(CFG, opt, remat=True, remat_policy="full",
                           use_kernel=True)
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, CFG.vocab_size, (2, 33), generator=g)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    tracing.reset()
    if not profiled:
        params, state, m = step(params, state, batch)
        return params, m["loss"], set()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        params, state, m = step(params, state, batch)
    return params, m["loss"], {e.name for e in prof.events()}


@pytest.fixture(scope="module")
def traced():
    params, loss, names = _one_step(True)
    recs = tracing.records()
    tracing.reset()
    return params, loss, names, recs


def test_off_records_nothing_and_costs_a_null_context():
    _one_step(False)
    assert tracing.records() == [] and tracing.counts() == {}
    assert tracing.span("x") is tracing.NULL
    assert tracing.span("x", B=2) is tracing.NULL
    assert not tracing.enabled()


def test_step_spans_and_their_parents(traced):
    _, _, _, recs = traced
    n = {}
    for r in recs:
        n[r.name] = n.get(r.name, 0) + 1
    assert n == {"train.step": 1, "train.forward": 1, "train.backward": 1,
                 "train.optimizer": 1, "attn.forward": 4, "attn.backward": 2}
    by = {r.name: r for r in recs if not r.name.startswith("attn.")}
    root = by["train.step"]
    assert root.parent is None
    assert all(by[p].parent == root.id for p in PHASES)
    assert {r.step for r in recs} == {root.id}
    fwd = [r.parent for r in recs if r.name == "attn.forward"]
    assert sorted(fwd) == sorted([by["train.forward"].id] * 2
                                 + [by["train.backward"].id] * 2)
    assert [r.parent for r in recs if r.name == "attn.backward"] == [
        by["train.backward"].id] * 2
    for r in recs:
        assert r.device_s is None            # no CUDA on this machine
        assert root.host_start <= r.host_start <= r.host_end \
            <= root.host_end
    attn = next(r for r in recs if r.name == "attn.forward")
    assert attn.attrs == {"B": 2, "Hq": CFG.n_heads, "Hkv": CFG.n_kv_heads,
                          "S": 32, "T": 32, "D": CFG.head_dim,
                          "causal": True, "window": 0, "dtype": "bfloat16"}


def test_every_span_is_a_profiler_range(traced):
    _, _, names, recs = traced
    assert {r.name for r in recs} <= names


def test_spans_change_no_number_of_the_step(traced):
    params, loss, _, _ = traced
    params_off, loss_off, _ = _one_step(False)
    assert torch.equal(loss, loss_off)
    for a, b in zip(leaves(params), leaves(params_off)):
        assert torch.equal(a, b)


def test_a_thread_with_no_open_span_hangs_under_the_innermost_open():
    rec = tracing.Recorder()
    got = {}

    def worker():
        with rec.span("inner", {}) as r:
            got["inner"] = r

    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("outer", {}) as outer:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert got["inner"].parent == outer.id
    assert got["inner"].step == outer.step == outer.id
    assert got["inner"].thread != outer.thread


def test_the_cap_counts_what_it_drops():
    rec = tracing.Recorder(cap=2)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with rec.span("s", {}):
                pass
    assert len(rec.records()) == 2 and rec.dropped() == 1
    assert rec.counts() == {"s": 3}
    rec.reset()
    assert rec.records() == [] and rec.dropped() == 0 and rec.counts() == {}


def test_device_time_is_read_from_two_events_per_span(monkeypatch):
    """Spans on a (stand-in) CUDA device: each records its own two
    timing events, and its device time is their interval, resolved when
    the records are read."""
    clock, made = itertools.count(), []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self):
            self.t = next(clock)

        def synchronize(self):
            pass

        def elapsed_time(self, end):        # milliseconds
            return float(end.t - self.t)

    rec = tracing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_initialized", lambda: True)
            m.setattr(torch.cuda, "is_current_stream_capturing",
                      lambda: False)
            m.setattr(torch.cuda, "Event", Event)
            for _ in range(2):
                with rec.span("outer", {}):
                    with rec.span("inner", {}):
                        pass
    assert len(made) == 8 and all(hasattr(e, "t") for e in made)
    got = [(r.name, r.device_s) for r in rec.records()]
    assert got == [("inner", 1e-3), ("outer", 3e-3)] * 2
    assert all(r.events is None for r in rec.records())
