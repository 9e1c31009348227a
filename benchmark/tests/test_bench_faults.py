"""The comparison that decides `correct` fails what it must: each cell's
run, with the harness's look for a card skipped and the timed path broken
underneath (the faults its runner's module names), comes out not correct;
and each cell's control (the reference in a lower precision in the
program's place) fails at least one of the cell's limits. Tiny sizes on
the CPU, so the controls here round in bf16 where the chip's round in
TF32."""

import json

import pytest

from benchmark import faults, harness
from benchmark.control import readings
from benchmark.tests import tiny

CELLS = [w["name"] for w in harness.spec()["workloads"]]


CASES = [(cell, fault) for cell in CELLS
         for fault in faults.names(harness.cell(cell)["traffic"]["runner"])]


@pytest.mark.parametrize("cell", CELLS)
def test_every_runner_plants_a_fault(cell):
    """A runner names its faults in its own module; a cell whose check is
    never shown to fail guards nothing."""
    kind = harness.cell(cell)["traffic"]["runner"]
    assert faults.names(kind), f"runner {kind} plants no fault"
    for name in faults.names(kind):
        obj, attr, broken = faults.plant(kind, name)
        assert callable(getattr(obj, attr)) and callable(broken), name


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    kind = harness.cell(cell)["traffic"]["runner"]
    monkeypatch.setattr(*faults.plant(kind, fault))
    r = tiny.run(cell)
    assert not r["correct"], json.dumps(r["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = tiny.shrink(harness.cell(cell))
    runner, program = readings(c, tiny.SEED, 1, "cpu")
    checks = runner.control("bf16")
    assert all(v <= c["traffic"]["limits"][n] for n, v in program.items())
    assert any(not (v <= lim) for _, v, lim in checks), checks
