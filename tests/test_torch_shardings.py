"""The port's sharding rules (``repro_torch.launch.shardings``) against
the JAX package's: for all 33 baseline pairs (and the paged variant of
each decode pair), on the 16x16 and 2x16x16 meshes, every param,
optimizer, cache, batch and engine-operand leaf's sanitized spec and
per-device shard shape equal JAX's ``NamedSharding``s, and so do the
per-chip argument bytes.  ``default_hint_rule`` and ``sanitize_spec``
agree on a list of kinds and shapes; placements follow JAX's major to
minor split."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun import case_ids, jax_dump  # noqa: E402

from repro_torch.launch.mesh import AbstractMesh, production_shape  # noqa: E402
from repro_torch.launch.shardings import (arg_shardings,  # noqa: E402
                                          default_hint_rule, per_chip_bytes,
                                          sanitize_spec, shard_shape,
                                          spec_leaves, to_placements)
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

CASES = case_ids()
MESHES = {"pod16x16": False, "pod2x16x16": True}
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4, "uint32": 4, "bool": 1,
            "int8": 1}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_dump(str(tmp_path_factory.mktemp("jax_shardings")))


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_leaf_specs_and_chip_bytes_match_jax(ref, case, mesh_name):
    arch, shape, kind = case.split("|")
    mesh = AbstractMesh(*production_shape(MESHES[mesh_name]))
    spec = input_specs(arch, shape, paged=kind == "paged", device="cpu")
    decode_tp = spec["shape"].kind == "decode"
    sh = arg_shardings(spec, mesh, decode_tp=decode_tp)
    want = ref["cases"][case]["meshes"][mesh_name]
    assert sorted(sh) == sorted(want)
    port_bytes = jax_bytes = 0
    for g in want:
        got = [[p, [_entry(e) for e in s], list(shard_shape(t.shape, s,
                                                             mesh))]
               for (p, t), s in zip(flatten_with_paths(spec[g]),
                                    spec_leaves(sh[g]))]
        assert got == want[g], (case, mesh_name, g)
        port_bytes += per_chip_bytes(spec[g], sh[g], mesh)
        dtypes = [d for _, _, d in ref["cases"][case]["leaves"][g]]
        jax_bytes += sum(math.prod(shard) * ITEMSIZE[dt]
                         for (_, _, shard), dt in zip(want[g], dtypes))
    assert port_bytes == jax_bytes


KINDS = ["cache/k", "cache/v", "cache/pos", "cache/ckv", "cache/krope",
         "cache/h", "cache/conv", "cache/state", "cache/shift", "moe_buffer",
         "moe_h", "moe_buffer_local", "moe_h_local", "moe_tokens",
         "ffn_hidden", "residual", "attn_q", "unknown"]
SHAPES = [(128, 32768, 8, 128), (128, 32768, 32, 128), (128, 1, 40, 128),
          (256, 4096, 12288), (16, 128, 8, 4096), (128, 1), (1, 524288),
          (128, 8192, 16), (1, 4096, 64, 64)]


def test_hint_rule_and_sanitize_match_jax():
    """Every kind x shape x (batch 128 | 1) x decode_tp on both meshes."""
    pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as JP
    from repro.launch import shardings as js
    checked = 0
    for multi in (False, True):
        shape, axes = production_shape(multi)
        mesh = AbstractMesh(shape, axes)
        jmesh = _JaxMeshShape(shape, axes)
        for batch in (128, 1):
            for tp in (False, True):
                rule = default_hint_rule(mesh, batch_size=batch, decode_tp=tp)
                jrule = js.default_hint_rule(jmesh, batch_size=batch,
                                             decode_tp=tp)
                for kind in KINDS:
                    for shp in SHAPES:
                        if kind.startswith("cache/") and len(shp) < 2:
                            continue
                        try:
                            want = jrule(kind, shp)
                        except (KeyError, AssertionError):
                            with pytest.raises(KeyError):
                                rule(kind, shp)
                            continue
                        got = rule(kind, shp)
                        assert (got is None) == (want is None), (kind, shp)
                        if got is None:
                            continue
                        assert [_entry(e) for e in got] == \
                            [_entry(e) for e in want], (kind, shp)
                        assert [_entry(e) for e in sanitize_spec(
                            got, shp, mesh)] == [_entry(e) for e in
                                                 js.sanitize_spec(
                                                     JP(*want), shp, jmesh)]
                        checked += 1
    assert checked > 500


class _JaxMeshShape:
    """What the JAX rules read of a mesh (``axis_names``, ``shape``,
    ``devices.shape``), with no devices behind it."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.devices = np.empty(shape, dtype=object)


def test_placements_split_major_to_minor():
    """A dim over ("pod", "data") is Shard(d) on both mesh dims, pod the
    major one; shard shapes divide as JAX's."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh(*production_shape(True))
    spec = (("pod", "data"), "model", None)
    assert to_placements(spec, mesh) == [Shard(0), Shard(0), Shard(1)]
    assert shard_shape((64, 32, 5), spec, mesh) == (2, 2, 5)
    assert to_placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        to_placements((("data", "pod"),), mesh)


def test_unknown_leaf_names_raise():
    from repro_torch.launch.shardings import cache_leaf_spec, param_specs
    mesh = AbstractMesh(*production_shape())
    with pytest.raises(KeyError):
        param_specs({"mystery": torch.zeros(4, 4)}, mesh)
    with pytest.raises(KeyError):
        cache_leaf_spec("mystery", long_ctx=False, dp=("data",), mp="model")
