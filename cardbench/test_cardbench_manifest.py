"""The manifest against the benchmark's contract, every cell's files found
by name, and a cell and a metric added as files alone picked up."""
import json
import re
import shutil

import pytest

from cardbench import manifest, model, testing

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load_manifest()

WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                   r"projection|_dim$|_rank$|experts_per_tok|expand)")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"][:2] == ["python3", "-m"] and len(M["command"]) <= 32
    assert M["paths"] == ["cardbench"]
    assert 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_keys(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    for e in M[kind]:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) - {"workloads"} == keys, e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_bounds_and_sources():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in M["per_layer"]:
        assert m["moves"] in names and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or (
                "_roofline." in m["name"]):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(cell):
    c = manifest.cell(M, cell)
    assert c.workload["name"] == cell == c.entry["name"]
    assert c.workload["config"] == c.entry["config"]
    assert c.workload["traffic"] == c.entry["traffic"]
    assert c.entry["chips"] in (1, 4)
    assert manifest.load_module("drivers", c.driver).run
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert manifest.load_module("metrics", m["name"]).read
    assert set(c.workload["check"]["limits"])


@pytest.mark.parametrize("conf", [c["name"] for c in M["configs"]])
def test_config_files(conf):
    entry = next(c for c in M["configs"] if c["name"] == conf)
    assert entry["file"] == f"cardbench/configs/{conf}.json"
    data = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert data["name"] == conf and data["source"] == entry["source"]
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        assert key in data["published"] and key in data
    assert manifest.load_module("reference", data["reference"]).hidden
    assert any(w["config"] == conf for w in M["workloads"])


@pytest.mark.parametrize("conf", [c["name"] for c in M["configs"]])
def test_port_section_states_the_published_widths(conf):
    data = json.loads((manifest.ROOT / "cardbench" / "configs"
                       / f"{conf}.json").read_text())
    p = data["port"]
    pairs = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab_size",
             "num_hidden_layers": "n_layers", "intermediate_size": "d_ff",
             "head_dim": "head_dim", "kv_lora_rank": "kv_lora_rank",
             "q_lora_rank": "q_lora_rank", "qk_nope_head_dim": "qk_nope_dim",
             "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "v_head_dim",
             "moe_intermediate_size": "d_expert",
             "n_routed_experts": "n_experts", "num_experts_per_tok": "top_k",
             "n_shared_experts": "n_shared_experts",
             "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta"}
    for hf, port_key in pairs.items():
        if hf in data:
            assert p[port_key] == data[hf], hf
    testing._program_on_path()
    cfg = model.port_config(data)
    assert cfg.n_layers == data["num_hidden_layers"]
    assert len(cfg.prefix_layers) == data.get("first_k_dense_replace", 0)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_param_tree_matches_the_program(cell):
    """The benchmark's tree (paths, shapes, dtypes, order) is the one the
    program's own initialiser builds, at a tiny size."""
    import torch
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import leaves
    c = testing.tiny_cell(cell)
    cfg = model.port_config(c.config)
    specs = model.param_specs(c.config["port"])
    flat = model.make_weights(specs, 7, "cpu")
    ours = model.tree(flat)
    theirs = init_params(0, cfg, device="cpu")
    a, b = list(leaves(ours)), list(leaves(theirs))
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    again = model.make_leaf(specs[3], 7, "cpu")
    assert torch.equal(again, flat[specs[3].path])


def _copy_package(tmp_path):
    pkg = tmp_path / "cardbench"
    for sub in ("configs", "workloads", "traffic", "metrics", "drivers",
                "reference"):
        shutil.copytree(manifest.PACKAGE / sub, pkg / sub)
    return pkg


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tmp_path):
    pkg = _copy_package(tmp_path)
    m = json.loads(json.dumps(M))
    base = manifest.read_json("workloads", testing.TRAIN)
    mix = dict(manifest.read_json("traffic", "lm-2x4096"), batch=1)
    (pkg / "traffic" / "lm-1x4096.json").write_text(json.dumps(mix))
    new = dict(base, name="qwen3-8b-8l.train-b1", traffic="lm-1x4096")
    (pkg / "workloads" / "qwen3-8b-8l.train-b1.json").write_text(
        json.dumps(new))
    (pkg / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return float(run['steps']) or None\n")
    m["workloads"].append({"name": "qwen3-8b-8l.train-b1",
                           "config": "qwen3-8b-8l", "traffic": "lm-1x4096",
                           "chips": 1, "why": "a smaller batch"})
    for e in m["end_to_end"]:
        if "workloads" in e and testing.TRAIN in e["workloads"]:
            e["workloads"].append("qwen3-8b-8l.train-b1")
    m["per_layer"].append({"name": "steps.train", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "train step", "moves":
                           "train_tokens_per_s",
                           "workloads": ["qwen3-8b-8l.train-b1"]})
    c = manifest.cell(m, "qwen3-8b-8l.train-b1", pkg)
    assert c.mix["batch"] == 1 and c.driver == "train_step"
    assert [p["name"] for p in c.per_layer] == ["steps.train"]
    assert [e["name"] for e in c.end_to_end] == ["setup_s",
                                                 "train_tokens_per_s"]
    got = manifest.read_metrics(c, {"kind": "train", "steps": 3}, pkg)
    assert got == {"steps.train": 3.0}
    assert manifest.read_metrics(c, {"kind": "train", "steps": 0}, pkg) == {}
    assert "steps.train" not in [
        p["name"] for p in manifest.cell(m, testing.TRAIN, pkg).per_layer]
    with pytest.raises(KeyError):
        manifest.cell(m, "no-such-cell", pkg)
