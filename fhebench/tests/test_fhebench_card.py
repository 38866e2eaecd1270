"""The control and the faults at the cells' own sizes, on the card, three
seeds each: every run has to come out not correct. Run on the card with
`python -m pytest fhebench/tests/test_fhebench_card.py -s`; each run
prints its readings (the upper readings of PERF.md's limits)."""

import json

import pytest

from fhebench.run import ROOT, run
from fhebench.tests import faults
from fhebench.tests.test_fhebench_run import CELLS, FAULTS, driver_of

SEEDS = (3700000001, 3700000002, 3700000003)
SECONDS = 3.0


def report(cell, what, seed, res):
    print(json.dumps({"cell": cell, "run": what, "seed": seed,
                      "correct": res["correct"], "checks": res["checks"]}))


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell, seed):
    with faults.keygen_slip():
        res = run(cell, seed, SECONDS, False)
    report(cell, "control", seed, res)
    assert not res["correct"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS[:1])
@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_on_the_card(card, cell, fault, seed):
    driver, batch = driver_of(ROOT, cell)
    if fault == "half_batch" and batch < 2:
        pytest.skip("a batch of one query has no half to leave out")
    with getattr(faults, fault)(driver):
        res = run(cell, seed, SECONDS, False)
    report(cell, fault, seed, res)
    assert not res["correct"]
