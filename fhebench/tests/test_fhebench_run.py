"""Whole runs of the harness at a tiny size with the program on the CPU:
every cell comes out correct; the control and each fault a cell can have
come out not correct; a cell added by data files alone runs; and no
module of JAX or the JAX package is loaded after a run."""

import json
import os
import subprocess
import sys

import pytest

from fhebench.run import ROOT, run
from fhebench.tests import faults
from fhebench.tests.tiny import tiny_checkout

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 12345


def driver_of(root, cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    with open(os.path.join(root, "fhebench", "workloads",
                           f"{entry['traffic']}.json")) as f:
        mix = json.load(f)
    return mix["driver"], mix.get("batch", 1)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("fhebench"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(checkout, cell):
    res = run(cell, SEED, 0.3, False, device="cpu", root=checkout)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(checkout, cell):
    """A key drawn one row late still decrypts (every answer right) and
    is caught by the word-for-word key comparison alone."""
    with faults.keygen_slip():
        res = run(cell, SEED, 0.3, False, device="cpu", root=checkout)
    checks = res["checks"]
    assert not res["correct"]
    assert checks["key_words_off"]["value"] > 0
    assert all(c["value"] == 0 for k, c in checks.items()
               if k != "key_words_off")


FAULTS = [(cell, fault) for cell in CELLS
          for fault in faults.FAULTS[driver_of(ROOT, cell)[0]]]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(checkout, cell, fault):
    driver, batch = driver_of(checkout, cell)
    if fault == "half_batch" and batch < 2:
        pytest.skip("a batch of one query has no half to leave out")
    with getattr(faults, fault)(driver):
        res = run(cell, SEED, 0.3, False, device="cpu", root=checkout)
    assert not res["correct"]
    assert res["checks"]["key_words_off"]["value"] == 0


def test_a_cell_added_by_data_files_alone_runs(checkout):
    """A later PR adds a cell by a workload file and a BENCHMARK.json
    entry, and the harness finds them by name."""
    with open(os.path.join(checkout, "fhebench", "workloads",
                           "mulrelin-b64.json")) as f:
        mix = json.load(f)
    mix["batch"], mix["check_rows"] = 2, 2
    with open(os.path.join(checkout, "fhebench", "workloads",
                           "mulrelin-b2.json"), "w") as f:
        json.dump(mix, f)
    path = os.path.join(checkout, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "mulrelin-b2",
                               "config": "bfv-n8192-q3x62",
                               "traffic": "mulrelin-b2", "chips": 1,
                               "why": "a throwaway cell"})
    with open(path, "w") as f:
        json.dump(bench, f)
    res = run("mulrelin-b2", SEED, 0.3, False, device="cpu", root=checkout)
    assert res["correct"] and res["attempted"] % 2 == 0


def test_no_jax_loaded_after_a_run(checkout):
    code = (
        "import sys\n"
        "from fhebench.run import run, forbidden_modules\n"
        f"res = run('mulpir-q16', {SEED}, 0.3, False, device='cpu', "
        f"root={checkout!r})\n"
        "assert res['correct']\n"
        "assert 'tpufhe_torch' in sys.modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from fhebench import run as harness

    monkeypatch.setitem(sys.modules, "tpufhe_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert "tpufhe_torch_like" not in harness.forbidden_modules()
    assert "jaxtyping" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpufhe.ops", object())
    assert harness.forbidden_modules() == ["tpufhe"]


def test_without_a_card_the_command_prints_nothing_and_fails():
    out = subprocess.run(
        [sys.executable, "-m", "fhebench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_trace_reduction_clips_to_the_window_and_scales_lost_launches():
    """A device event past the window's host clock bounds is clipped to
    them, and a kernel's recorded bounds are scaled to its launches in the
    trace while the two counts differ by at most 0.1 %."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from fhebench.trace import TraceSummary

    class Event:
        def __init__(self, s, e, name):
            self.s, self.e, self.n = s, e, name

        def start_ns(self):
            return self.s

        def end_ns(self):
            return self.e

        def name(self):
            return self.n

        def device_type(self):
            return DeviceType.CUDA

        def duration_ns(self):
            return self.e - self.s

    def summary(launches, recorded):
        events = [Event(990 + 10 * i, 995 + 10 * i, "ntt_row_kernel")
                  for i in range(launches)]
        events.append(Event(980, 990, "vectorized_elementwise_kernel"))
        prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events)))
        calls = [("ntt", (1e-9, "bytes"))] * recorded
        return TraceSummary(prof, calls, (1000, 1000 + 10 * launches), [])

    t = summary(2000, 2001)
    # the first launch and the elementwise kernel start before the window
    assert t.busy_s * 1e9 == 5 * 1999
    assert t.port_count == {"ntt": 2000} and t.port_ns["ntt"] == 5 * 2000
    assert t.bound_of_traced() == pytest.approx(2000e-9)
    assert summary(2000, 2010).bound_of_traced() is None
