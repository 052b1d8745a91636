"""The comparison that decides ``correct``, driven through the rest of a
run at a tiny size on the CPU: a sound run passes the cell's limits; the
control (the plain reference in float8 put in the program's place) and
each fault the cell can have, planted under the timed path, fail them."""
import pytest

from cardbench import check, manifest, testing

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def train():
    c = testing.tiny_cell(testing.TRAIN)
    return c, testing.run_tiny(c, SEED, seconds=0.2)


def _limits(c):
    return c.workload["check"]["limits"]


def test_sound_training_run_is_correct(train):
    c, res = train
    assert check.verdict(res["numbers"], _limits(c)), res["numbers"]
    assert res["failed"] == 0 and res["attempted"] >= 4


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_training_fault_is_caught(fault):
    c = testing.tiny_cell(testing.TRAIN)
    res = testing.run_tiny(c, SEED, fault=fault, seconds=0.2)
    assert not check.verdict(res["numbers"], _limits(c)), res["numbers"]


@pytest.mark.parametrize("kind", ["control", "half_batch_in_reference"])
def test_training_control_is_not_correct(train, kind):
    from cardbench.traffic import lm_batches
    c, res = train
    driver = manifest.load_module("drivers", c.driver)
    rows = lm_batches(c.mix, SEED, c.workload["check"]["steps"],
                      c.config["port"]["vocab_size"])
    kw = {"control": dict(lowp=True),
          "half_batch_in_reference": dict(half_batch=True)}[kind]
    other = driver.reference(c, SEED, "cpu", rows, **kw)
    numbers = check.train_numbers(other, res["ref"],
                                  c.workload["check"]["keep_below_median"])
    assert not check.verdict(numbers, _limits(c)), numbers


def test_a_frozen_state_reads_one():
    ref = {"losses": [1.0, 0.9], "grad1": {"a": 1.0, "b": 2.0},
           "delta": {"a": 0.1, "b": 0.3}}
    prog = {"losses": [1.0, 1.0], "grad1": {"a": 0.0, "b": 0.0},
            "delta": {"a": 0.0, "b": 0.0}}
    n = check.train_numbers(prog, ref, 1e-3)
    assert n["delta_gap"] == pytest.approx(1.0)
    assert n["grad_gap"] == pytest.approx(1.0)


def test_verdict_needs_every_limit():
    assert not check.verdict({"a": 0.1}, {"a": 0.2, "b": 1.0})
    assert not check.verdict({"a": float("nan")}, {"a": 0.2})
    assert not check.verdict({"a": 0.1}, {"a": None})
    assert check.verdict({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0})



@pytest.fixture(scope="module")
def calibrated():
    from cardbench import calibrate
    c = testing.tiny_cell(testing.TRAIN)
    return {r["reading"]: r for r in calibrate.readings(
        c, SEED, 0.2, control=True, faults=True, device="cpu")}


@pytest.mark.parametrize("reading,correct", [("program", True),
                                             ("control", False),
                                             ("half_batch", False)])
def test_calibrate_gives_each_reading_its_verdict(calibrated, reading,
                                                  correct):
    r = calibrated[reading]
    limits = _limits(testing.tiny_cell(testing.TRAIN))
    assert r["correct"] is correct, r["numbers"]
    assert r["correct"] == check.verdict(r["numbers"], limits)
