"""The readers of the program's spans (``attn_fwd_roofline.train``,
``attn_bwd_roofline.train``, ``adamw_roofline.train``) on synthetic
records at the training cell's shape, values computed by hand; and
nothing to read without records, without device times, or without the
program's span recorder."""
import math
import sys

import pytest

from cardbench import manifest, model, testing

M = manifest.load_manifest()
NEW = ("attn_fwd_roofline.train", "attn_bwd_roofline.train",
       "adamw_roofline.train")
SHAPE = {"B": 2, "Hq": 32, "Hkv": 8, "S": 4096, "T": 4096, "D": 128,
         "causal": True, "window": 0, "dtype": "bfloat16"}


def _run():
    c = manifest.cell(M, testing.TRAIN)
    return {"kind": "train", "port": c.config["port"]}


def _records(monkeypatch, spans):
    """Make the program's recorder return ``spans``: (name, attrs,
    device seconds) each."""
    testing._program_on_path()
    from repro_torch import tracing
    recs = [tracing.Record(name, i, None, i, 0, attrs, 0.0, 1.0, dev)
            for i, (name, attrs, dev) in enumerate(spans)]
    monkeypatch.setattr(tracing, "records", lambda: recs)


def _read(name):
    return manifest.load_module("metrics", name).read(_run())


def test_attn_fwd_reads_flash_bound_over_device_time(monkeypatch):
    _records(monkeypatch, [("attn.forward", SHAPE, 961.2e-6)] * 16
             + [("attn.backward", SHAPE, 1.0)])
    # flash_bound at the training shape: 274.9 GFLOP at 989 TFLOP/s
    assert _read("attn_fwd_roofline.train") == pytest.approx(
        100 * 278.0030e-6 / 961.2e-6, rel=1e-6)
    assert round(_read("attn_fwd_roofline.train"), 2) == 28.92


def test_attn_bwd_bound_is_two_and_a_half_forwards(monkeypatch):
    mod = manifest.load_module("metrics", "attn_bwd_roofline.train")
    # 2.5 x 274,945,015,808 flops = 687.36 GFLOP over 989e12
    assert mod.bound(SHAPE) == pytest.approx(687.3625e9 / 989e12, rel=1e-6)
    _records(monkeypatch, [("attn.backward", SHAPE, 695.0076e-6)] * 8)
    assert _read("attn_bwd_roofline.train") == pytest.approx(100, abs=1e-3)
    _records(monkeypatch, [("attn.backward", SHAPE, 0.035)] * 8)
    assert _read("attn_bwd_roofline.train") == pytest.approx(
        100 * 695.0076e-6 / 0.035, rel=1e-5)


def test_attn_bwd_bytes_bound_a_float32_call_with_few_queries():
    mod = manifest.load_module("metrics", "attn_bwd_roofline.train")
    a = dict(SHAPE, S=1, dtype="float32")
    byts = (4 * 2 * 32 * 1 * 128 + 4 * 2 * 8 * 4096 * 128) * 4 + 2 * 32 * 4
    assert mod.bound(a) == pytest.approx(byts / 3.35e12, rel=1e-9)


def test_adamw_reads_28_bytes_an_element(monkeypatch):
    mod = manifest.load_module("metrics", "adamw_roofline.train")
    port = _run()["port"]
    assert sum(math.prod(s.shape) for s in model.param_specs(port)) \
        == 2_788_235_264
    assert mod.bound_s(port) == pytest.approx(2_788_235_264 * 28 / 3.35e12)
    _records(monkeypatch, [("train.optimizer", {}, 0.2)] * 2
             + [("train.step", {}, 0.9)] * 2)
    assert _read("adamw_roofline.train") == pytest.approx(
        100 * 0.0233047 / 0.2, rel=1e-5)


def test_a_call_without_the_causal_mask_counts_every_pair(monkeypatch):
    from cardbench import spans
    full = dict(SHAPE, causal=False)
    # 2 x 32 x 4096 x 4096 pairs x 2 products x 2 x 128: 549.76 GFLOP
    assert spans.attn_fwd(full)[2] == 2 * 32 * 4096 * 4096 * 2 * 2 * 128
    assert spans.attn_fwd(full)[1] == spans.attn_fwd(SHAPE)[1]
    _records(monkeypatch, [("attn.forward", full, 1e-3)])
    assert _read("attn_fwd_roofline.train") == pytest.approx(
        100 * 549.7558e9 / 989e12 / 1e-3, rel=1e-6)
    bwd = manifest.load_module("metrics", "attn_bwd_roofline.train")
    assert bwd.bound(full) == pytest.approx(2 * bwd.bound(SHAPE), rel=1e-3)
    with pytest.raises(ValueError):
        spans.attn_fwd(dict(full, window=1024))


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(monkeypatch, name):
    _records(monkeypatch, [])
    assert _read(name) is None
    # the CPU: spans recorded, none with a device time
    _records(monkeypatch, [(n, SHAPE, None) for n in
                           ("attn.forward", "attn.backward",
                            "train.optimizer")])
    assert _read(name) is None
    # a program without the recorder (the parent of the readers)
    _records(monkeypatch, [(n, SHAPE, 1.0) for n in
                           ("attn.forward", "attn.backward",
                            "train.optimizer")])
    assert _read(name) is not None
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _read(name) is None
    assert manifest.load_module("metrics", name).read({"kind": "serve"}) \
        is None


@pytest.mark.parametrize("name", NEW)
def test_the_manifest_entry_reports_in_the_train_cell(name):
    entry = next(m for m in M["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "%"
    assert entry["moves"] == "train_tokens_per_s"
    assert entry["workloads"] == [testing.TRAIN]
    layers = {m["layer"] for m in M["per_layer"]}
    assert entry["layer"] in layers
    c = manifest.cell(M, testing.TRAIN)
    assert name in [m["name"] for m in c.per_layer]
