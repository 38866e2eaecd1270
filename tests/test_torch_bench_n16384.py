"""The benchmark's cell mulrelin-n16384-b16 (BASELINE config 5's ring,
N = 16384 with 6 x 62-bit moduli, on the unfused mul+relin route) and the
readers of its stage spans, at a tiny size on the CPU.

The cell's files are cut to degree 64 by fhebench/tests/tiny.py, where the
fused kernels fit, so ``kernels.tail_fits`` is forced false to take the
route that N = 16384 takes (K7 + K1 inverse, K1 forward + ks_accumulate);
spies on the pipeline's functions show which route ran. On the CPU the
plain versions run and no launch is counted. The answers are held against
fhebench/reference/ as on the card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from fhebench.metrics import _spans, ntt_roofline, relin_ms, tensor_ms
from fhebench.run import metrics_of, resolve, run
from fhebench.tests import faults
from fhebench.tests.tiny import tiny_checkout
from fhebench.trace import TraceSummary
from fhebench.traffic import common
from tpufhe_torch import kernels
from tpufhe_torch import pipeline as tpl
from tpufhe_torch.bfv import RelinearizationKey, SecretKey
from tpufhe_torch.utils import obs

CELL = "mulrelin-n16384-b16"
SEED = 2 ** 33 + 1021
STAGES = ("mul_relin.tensor", "mul_relin.relin")
# the functions whose calls show the route a step took (relin_tail runs on
# both routes and chooses between them; its plain K4 only on the fused one)
UNFUSED = ("tensor", "ks_accumulate")
FUSED = ("tensor_intt", "relin_tail_plain")
# the cell's per-layer metrics (BENCHMARK.json)
LAYER_METRICS = {"tensor_ms.n16k", "relin_ms.n16k", "ntt_roofline.n16k",
                 "kernels_roofline.n16k", "glue_device_pct.n16k",
                 "device_idle_pct.n16k", "launches_per_op.n16k"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("n16384"))


def spy_route(monkeypatch, fits: bool) -> dict:
    """Force the route rule to `fits` and count the calls of the route's
    functions in the pipeline module."""
    monkeypatch.setattr(kernels, "tail_fits",
                        lambda n, word_bytes=8: fits)
    calls = dict.fromkeys(UNFUSED + FUSED, 0)
    for name in calls:
        def spy(*a, _fn=getattr(tpl, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tpl, name, spy)
    return calls


def test_cell_files_state_the_ring_its_route_and_its_cut():
    bench, entry, config, mix = resolve(CELL)
    assert entry["chips"] == 1 and entry["config"] == "bfv-n16384-q6x62"
    assert (config["degree"], config["moduli_sizes"]) == (16384, [62] * 6)
    assert (config["plaintext_modulus"] - 1) % (2 * config["degree"]) == 0
    assert not kernels.tail_fits(config["degree"])
    assert (mix["driver"], mix["batch"], mix["pool"]) == ("mulrelin", 16, 3)
    # the one cut, stated in the file and named in BENCHMARK.json's reduced
    assert config["resident_ciphertexts"] == mix["pool"] * mix["batch"]
    assert next(c for c in bench["configs"] if c["name"] == entry["config"]
                )["reduced"] == ["resident_ciphertexts"]
    assert {m["name"] for m in metrics_of(bench, CELL, True)} == LAYER_METRICS
    assert [m["name"] for m in metrics_of(bench, CELL, False)] == [
        "ct_ops_per_s", "setup_s"]
    # each new entry appended at the end of its list (the cell's per-layer
    # metrics one block, which later entries follow); ct_ops_per_s keeps
    # its bound
    assert bench["configs"][-1]["name"] == entry["config"]
    assert bench["workloads"][-1]["name"] == CELL
    names = [m["name"] for m in bench["per_layer"]]
    first = min(names.index(n) for n in LAYER_METRICS)
    assert set(names[first:first + len(LAYER_METRICS)]) == LAYER_METRICS
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["ct_ops_per_s"]["workloads"] == ["mulrelin-b64", CELL]
    assert e2e["ct_ops_per_s"]["bound"] == 0.012


def test_cell_runs_the_unfused_route_and_is_correct(checkout, monkeypatch):
    calls = spy_route(monkeypatch, False)
    res = run(CELL, SEED, 0.3, False, device="cpu", root=checkout)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    # the window's steps and the two warm-up steps, each on the unfused route
    steps = res["attempted"] // 4 + 2
    assert calls == {"tensor": steps, "ks_accumulate": steps,
                     "tensor_intt": 0, "relin_tail_plain": 0}
    assert not any(kernels.LAUNCHES.values())


def test_an_altered_answer_on_the_unfused_route_is_caught(checkout,
                                                          monkeypatch):
    calls = spy_route(monkeypatch, False)
    with faults.answer_altered("mulrelin"):
        res = run(CELL, SEED, 0.3, False, device="cpu", root=checkout)
    assert calls["tensor"] > 0 and calls["tensor_intt"] == 0
    assert not res["correct"]
    assert res["checks"]["wrong_slots"]["value"] > 0
    assert res["checks"]["key_words_off"]["value"] == 0


@pytest.mark.parametrize("fits", [True, False], ids=["fused", "unfused"])
def test_both_routes_open_the_two_stage_spans_once_a_step(monkeypatch, fits):
    calls = spy_route(monkeypatch, fits)
    _, _, config, _ = resolve(CELL)
    par = common.program_params({**config, "degree": 16}, "cpu")
    rng = common.program_rng(SEED)
    sk = SecretKey.random(par, rng)
    rk = RelinearizationKey.new(sk, rng)
    msgs = np.arange(2 * 2 * 16, dtype=np.uint64).reshape(2, 2, 16)
    c0, c1 = common.encrypt_batches(sk, msgs, rng)
    step = tpl.make_mul_relin(par, rk)
    with obs.recording() as rec:
        for _ in range(3):
            step(c0[0], c1[0], c0[1], c1[1])
    tops = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in tops] == ["mul_relin"] * 3
    for top in tops:
        assert [c.name for c in rec.children(top)] == list(STAGES)
        assert all(not rec.children(c) for c in rec.children(top))
    route = FUSED if fits else UNFUSED
    assert all(calls[name] == 3 for name in route)
    assert not any(calls[name] for name in set(calls) - set(route))


def test_the_stage_readers_find_no_device_bounds_on_the_cpu(checkout,
                                                            monkeypatch):
    spy_route(monkeypatch, False)
    res = run(CELL, SEED, 0.3, True, device="cpu", root=checkout)
    assert res["correct"], res["checks"]
    rec = _spans.recording()
    names = [s.name for s in rec.spans]
    assert names.count("mul_relin.tensor") == names.count("mul_relin") > 0
    assert names.count("mul_relin.relin") == names.count("mul_relin")
    assert tensor_ms.read(None, "tensor_ms.n16k") is None
    assert relin_ms.read(None, "relin_ms.n16k") is None
    assert not LAYER_METRICS & set(res["metrics"])


class _Event:
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


def _window(ntt_recorded: int) -> SimpleNamespace:
    """A window of 4 K1 launches of 10 ns (split and whole-row) and 2 K7
    launches of 20 ns; the recorder saw ntt_recorded K1 launches of 2 ns
    bound each, and both K7 launches at 5 ns."""
    names = ["ntt_split_kernel", "ntt_row_kernel"] * 2
    events = [_Event(1000 + 10 * i, 1010 + 10 * i, n)
              for i, n in enumerate(names)]
    events += [_Event(1040 + 20 * i, 1060 + 20 * i, "tensor_kernel")
               for i in range(2)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    calls = ([("ntt", (2e-9, "bytes"))] * ntt_recorded
             + [("tensor", (5e-9, "bytes"))] * 2)
    return SimpleNamespace(trace=TraceSummary(prof, calls, (1000, 1080), []))


def test_ntt_roofline_reads_k1_alone():
    assert ntt_roofline.read(_window(4), "ntt_roofline.n16k") == \
        pytest.approx(100.0 * 8 / 40)
    # a K1 launch missing from the record leaves the share unread
    assert ntt_roofline.read(_window(3), "ntt_roofline.n16k") is None
    assert ntt_roofline.read(SimpleNamespace(trace=None), "x") is None

