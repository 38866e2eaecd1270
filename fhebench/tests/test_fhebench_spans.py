"""The readers of the program's own spans and counters, on traced runs of
the tiny cells with the program on the CPU: the glue counts per operation
repeat exactly across seeds, the enqueue time is read, and the readers of
device-timed spans find no device bounds on the CPU and leave their
metrics out."""

import json
import os

import pytest

from fhebench.metrics import _spans
from fhebench.run import ROOT, metrics_of, run
from fhebench.tests.tiny import tiny_checkout

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
SEEDS = (2 ** 31 + 19, 2 ** 33 + 7)
# the per-layer metrics whose readers read tpufhe_torch.utils.obs
SPAN_READERS = ("glue_calls_per_op", "enqueue_ms_per_op", "keyswitch_ms",
                "switch_down_ms", "fold_ms")
DEVICE_TIMED = ("keyswitch_ms", "switch_down_ms", "fold_ms")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("fhebench_spans"))


def span_metrics(cell):
    return [m["name"] for m in metrics_of(BENCH, cell, True)
            if m["name"].split(".")[0] in SPAN_READERS]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if span_metrics(w["name"])])
def test_traced_runs_read_the_programs_spans_and_counters(checkout, cell):
    readings = []
    for seed in SEEDS:
        res = run(cell, seed, 0.3, True, device="cpu", root=checkout)
        assert res["correct"], res["checks"]
        readings.append(res["metrics"])
    for name in span_metrics(cell):
        reader = name.split(".")[0]
        if reader in DEVICE_TIMED:
            assert all(name not in r for r in readings)
        elif reader == "glue_calls_per_op":
            assert readings[0][name]["value"] == readings[1][name]["value"]
        else:
            assert all(r[name]["value"] > 0 for r in readings)


def test_untraced_runs_leave_the_recording_alone(checkout):
    """An untraced run records nothing: the readers keep reading the last
    traced window's recording, which no untraced run replaces."""
    run("mulrelin-b64", SEEDS[0], 0.3, True, device="cpu", root=checkout)
    rec = _spans.recording()
    assert rec is not None and {s.name for s in rec.spans} == {"mul_relin"}
    run("innerprod-b64", SEEDS[0], 0.3, False, device="cpu", root=checkout)
    assert _spans.recording() is rec
