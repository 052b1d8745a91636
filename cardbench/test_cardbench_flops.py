"""The yardstick's arithmetic against hand counts and against the numbers
the bring-up runs printed for the same shapes."""
import json

import pytest

from cardbench import flops, manifest, trace


def _port(name):
    return json.loads((manifest.PACKAGE / "configs" / f"{name}.json")
                      .read_text())["port"]


def test_train_flops_at_the_cell():
    # chip_smoke.py printed 113.05 TFLOP a step for qwen3-8b, 8 layers,
    # B 2 x 4096
    assert flops.train_flops(_port("qwen3-8b-8l"), 2, 4096) == pytest.approx(
        113.053739778048e12, rel=1e-12)


def test_train_flops_by_hand():
    p = dict(d_model=4, head_dim=2, n_heads=2, n_kv_heads=1, d_ff=8,
             n_layers=1, vocab_size=10)
    # matmul params: 4*2*(4+2) + 3*4*8 = 144 per layer, head 40
    # pairs: B 1 x heads 2 x (1+2+3) = 12; 3 x 12 x 2 x 2 x 2
    assert flops.train_flops(p, 1, 3) == 6 * 184 * 3 + 3 * 12 * 2 * 2 * 2


def test_flash_bound_at_the_cell():
    s, byts, fl = flops.flash_bound(2, 32, 8, 4096, 4096, 128)
    assert s * 1e6 == pytest.approx(278.0, abs=0.05)     # PERF.md row 2
    assert byts == 168820736 and fl == 274945015808.0


def test_causal_pairs():
    assert flops.causal_pairs(3, 3) == 6
    assert flops.causal_pairs(2, 5) == 4 + 5
    assert flops.causal_pairs(4, 4, window=2) == 1 + 2 + 2 + 2


def test_union_of_kernel_intervals():
    busy, gaps = trace.union_length([(1, 3), (2, 5), (7, 8), (0, 0.5)],
                                    0, 10)
    assert busy == 0.5 + 4 + 1
    assert gaps == [(0.5, 1), (5, 7), (8, 10)]
    busy, gaps = trace.union_length([], 0, 2)
    assert busy == 0 and gaps == [(0, 2)]


class _R:
    def __init__(self, a, b):
        self.start, self.end = a, b


class _E:
    def __init__(self, name, a, b, device=False):
        import torch
        self.name, self.time_range = name, _R(a, b)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)


def test_reduce_labels_idle_gaps_by_host_span():
    ev = [_E(trace.WINDOW, 0, 100), _E("train_step", 10, 90),
          _E("train_step", 10, 90, True), _E("k1", 0, 20, True),
          _E("k2", 30, 60, True), _E("k1", 80, 95, True)]
    tr = trace.reduce(ev)
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["busy_s"] == pytest.approx(65e-6)     # the span's device copy is no kernel
    assert tr["gaps"][0] == ("train_step", pytest.approx(20e-6))
    assert [g[0] for g in tr["gaps"]] == ["train_step", "train_step",
                                          "harness"]
    assert tr["by_kernel"] == {"k1": pytest.approx(35e-6),
                               "k2": pytest.approx(30e-6)}
    assert trace.idle_share(tr) == pytest.approx(35.0)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == "k1" and len(bd["idle_gaps"]) == 3
