"""The port's dry-run inputs (``repro_torch.launch.specs``) against the
JAX package's: for all 33 baseline pairs and the paged engine-step
variant of each decode pair, every leaf's path, shape and dtype equals
``jax.eval_shape``'s, with the optimizer state at 32 and 8 bits; the
input-shape matrix and its 33 pairs / 7 skips are the same."""
import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun import case_ids, dtype_name, jax_dump  # noqa: E402

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 baseline_pairs)
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

CASES = case_ids()
GROUPS = ("params", "opt_state", "batch", "caches", "positions", "table",
          "sampling")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_specs"))
    return {32: jax_dump(d, 32), 8: jax_dump(d, 8)}


def port_leaves(spec, group):
    return [[p, list(t.shape), dtype_name(t)]
            for p, t in flatten_with_paths(spec[group])]


def test_input_shapes_and_pairs_match_jax(dumps):
    import repro.configs as jc
    ref = dumps[32]
    assert {k: [v.name, v.seq_len, v.global_batch, v.kind]
            for k, v in INPUT_SHAPES.items()} == ref["input_shapes"]
    pairs, skips = baseline_pairs()
    assert [list(p) for p in pairs] == ref["pairs"]
    assert [list(s) for s in skips] == ref["skips"]
    assert len(pairs) == 33 and len(skips) == 7
    assert ASSIGNED_ARCHS == jc.ASSIGNED_ARCHS


@pytest.mark.parametrize("case", CASES)
def test_input_specs_match_jax_eval_shape(dumps, case):
    arch, shape, kind = case.split("|")
    spec = input_specs(arch, shape, paged=kind == "paged", device="cpu")
    ref = dumps[32]["cases"][case]["leaves"]
    assert sorted(g for g in GROUPS if g in spec) == sorted(ref)
    for g in ref:
        assert port_leaves(spec, g) == ref[g], (case, g)


@pytest.mark.parametrize("case", [c for c in CASES if "train_4k" in c])
def test_int8_optimizer_state_matches_jax(dumps, case, monkeypatch):
    monkeypatch.setenv("REPRO_OPT_BITS", "8")
    arch, shape, _ = case.split("|")
    spec = input_specs(arch, shape, device="cpu")
    assert port_leaves(spec, "opt_state") == \
        dumps[8]["cases"][case]["leaves"]["opt_state"]


def test_specs_are_fake_and_on_the_asked_device():
    """The stand-ins hold no storage, and a "cuda" program needs no GPU."""
    from torch._subclasses.fake_tensor import FakeTensor
    spec = input_specs("qwen3-8b", "decode_32k", paged=True)
    for g in ("params", "caches", "table", "sampling"):
        for _, t in flatten_with_paths(spec[g]):
            assert isinstance(t, FakeTensor) and t.device.type == "cuda"
