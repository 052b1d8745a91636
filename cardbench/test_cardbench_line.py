"""The result line's shape: its keys, the metrics of each mode, and the
compared numbers beside their limits as its last key and as the last
lines of standard error."""
import json

from cardbench import manifest, run, testing


def _fake():
    r = {"kind": "train", "spans": [], "window_s": 10.0, "steps": 11,
         "trace": None, "port": testing.tiny_cell(testing.TRAIN)
         .config["port"], "batch": 2, "seq_len": 32}
    return {"setup_s": 12.5, "e2e": {"train_tokens_per_s": 704.0},
            "attempted": 3, "failed": 0, "memory_peak_bytes": 123,
            "numbers": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                        "delta_gap": 1e-3}, "run": r}


def _line(capsys, trace_on):
    c = manifest.cell(manifest.load_manifest(), testing.TRAIN)
    assert run.emit(c, _fake(), trace_on, "NVIDIA H100 80GB HBM3") == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    return c, line, err


def test_end_to_end_line(capsys):
    c, line, err = _line(capsys, False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in c.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
    assert line["metrics"]["train_tokens_per_s"]["value"] == 704.0
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3",
                              "count": 1, "memory_peak_bytes": 123}
    limits = c.workload["check"]["limits"]
    assert set(line["check"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    assert all(t.startswith("check ") for t in tail)


def test_traced_line_reads_per_layer_metrics(capsys):
    c, line, _ = _line(capsys, True)
    # no trace in the fake run: only the host-clock reader finds something
    assert set(line["metrics"]) == {"mfu.train"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert list(line)[-1] == "check"
