"""The port's tracer (tpufhe_torch.utils.obs) on the CPU: off, it records
nothing and the programs' outputs are those of a recorded run; on, spans
nest by parent id, the expansion's doublings are tiled by their three
stages, the glue counters read what the code issues, recording follows a
torch.profiler session, the Chrome export holds one event a span, and the
kernels' launch counter keeps its behaviour."""

import json
import logging

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpufhe_torch import kernels
from tpufhe_torch.bfv import (
    BfvParametersBuilder,
    Encoding,
    EvaluationKeyBuilder,
    Plaintext,
    RelinearizationKey,
    SecretKey,
)
from tpufhe_torch.ops.rq import ntt_forward
from tpufhe_torch.pipeline import make_expand, make_inner_sum, make_mul_relin
from tpufhe_torch.utils import obs
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

DEGREE = 64
LEVELS = 3


def bfv_params(degree, t, sizes):
    return (BfvParametersBuilder().set_degree(degree)
            .set_plaintext_modulus(t).set_moduli_sizes(sizes)
            .set_variance(10).set_device("cpu").build())


@pytest.fixture(scope="module")
def programs():
    """{name: (program, inputs)} at degree 64: the leveled expansion of
    MulPIR (keys at level 0 for ciphertexts at level 1), the expansion and
    the inner sum with keys at the ciphertexts' level, and mul+relin."""
    rng = ChaCha8Rng(seed_from_u64(19))
    pir = bfv_params(DEGREE, 1785857, [50, 55, 55])
    sk = SecretKey.random(pir, rng)
    ek_leveled = (EvaluationKeyBuilder(sk, ciphertext_level=1,
                                       evaluation_key_level=0)
                  .enable_expansion(LEVELS).build(rng))
    query = sk.try_encrypt(Plaintext.try_encode([1, 2, 3], Encoding.poly(1),
                                                pir), rng)
    ring = bfv_params(DEGREE, 65537, [62, 62, 62])
    sk2 = SecretKey.random(ring, rng)
    ek = (EvaluationKeyBuilder(sk2).enable_expansion(LEVELS)
          .enable_inner_sum().build(rng))
    rk = RelinearizationKey.new(sk2, rng)
    cts = [sk2.try_encrypt(Plaintext.try_encode(
        list(range(i, i + DEGREE)), Encoding.simd(), ring), rng)
        for i in range(4)]
    c0 = torch.stack([ct[0] for ct in cts])
    c1 = torch.stack([ct[1] for ct in cts])
    return {
        "expand_leveled": (make_expand(pir, ek_leveled, LEVELS, level=1),
                           (query[0][None], query[1][None])),
        "expand": (make_expand(ring, ek, LEVELS), (c0[:2], c1[:2])),
        "inner_sum": (make_inner_sum(ring, ek), (c0, c1)),
        "mul_relin": (make_mul_relin(ring, rk), (c0[:2], c1[:2], c0[2:],
                                                 c1[2:])),
    }


# the glue counters one call of each program implies: a leveled doubling
# substitutes both parts, switches down (an add, a sub and a Shoup product
# of rq.switch_down) and adds s0 back after its K1 forward, then folds (2
# subs, 2 Shoup products, 2 adds); a doubling at the key's level rotates
# by K1 + K5 (kernels) and folds; a rotation of the inner sum substitutes
# both parts (K1 + K5) and adds both; mul+relin is kernels, stack and cat
ROTATIONS = DEGREE.bit_length() - 1
GLUE = {
    "expand_leveled": {"glue.rq.substitute": 2 * LEVELS,
                       "glue.zq.add": 4 * LEVELS, "glue.zq.sub": 3 * LEVELS,
                       "glue.zq.mul_shoup": 3 * LEVELS,
                       "rq.switch_down": LEVELS},
    "expand": {"glue.rq.substitute": 2 * LEVELS, "glue.zq.add": 2 * LEVELS,
               "glue.zq.sub": 2 * LEVELS, "glue.zq.mul_shoup": 2 * LEVELS},
    "inner_sum": {"glue.rq.substitute": 2 * ROTATIONS,
                  "glue.zq.add": 2 * ROTATIONS},
    "mul_relin": {},
}
TOP = {"expand_leveled": "expand", "expand": "expand",
       "inner_sum": "inner_sum", "mul_relin": "mul_relin"}


@pytest.mark.parametrize("name", sorted(GLUE))
def test_off_records_nothing_and_outputs_match_a_recorded_run(programs, name):
    program, args = programs[name]
    before = obs.latest()
    n_before = None if before is None else len(before.spans)
    off = program(*args)
    assert obs.latest() is before
    assert before is None or len(before.spans) == n_before
    with obs.recording() as rec:
        on = program(*args)
    assert rec.spans and obs.latest() is rec
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_off_a_span_is_one_shared_no_op():
    assert obs.span("x") is obs.span("x")
    assert obs.span("x", device=True) is obs.span("x", device=True)
    with obs.span("x") as s:
        pass
    assert not isinstance(s, obs.Span)


@pytest.mark.parametrize("name", sorted(GLUE))
def test_glue_counts_are_what_the_code_issues(programs, name):
    program, args = programs[name]
    with obs.recording() as rec:
        program(*args)
    assert rec.counters == GLUE[name]
    tops = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in tops] == [TOP[name]]


def test_spans_nest_by_parent_and_self_time_is_the_span_less_children():
    with obs.recording() as rec:
        with obs.span("a"):
            with obs.span("b"):
                with obs.span("c"):
                    pass
            with obs.span("d"):
                pass
        with obs.span("e"):
            pass
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["c", "b", "d", "a", "e"]
    assert len({s.id for s in rec.spans}) == 5
    assert by["a"].parent is None and by["e"].parent is None
    assert by["b"].parent == by["a"].id and by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    assert rec.children(by["a"]) == [by["b"], by["d"]]
    for s in rec.spans:
        assert s.device is None  # host bounds only on the CPU
        assert s.start_ns <= s.end_ns
        kids = rec.children(s)
        assert rec.self_ns(s) == (s.end_ns - s.start_ns) - sum(
            k.end_ns - k.start_ns for k in kids)
        for k in kids:
            assert s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns


@pytest.mark.parametrize("name", ["expand_leveled", "expand"])
def test_expansion_doublings_are_tiled_by_three_stages(programs, name):
    program, args = programs[name]
    with obs.recording() as rec:
        program(*args)
    (top,) = [s for s in rec.spans if s.parent is None]
    assert top.name == "expand"
    doublings = rec.children(top)
    assert [d.name for d in doublings] == ["expand.doubling"] * LEVELS
    for d in doublings:
        stages = rec.children(d)
        assert [s.name for s in stages] == ["keyswitch", "switch_down",
                                            "fold"]
        assert d.start_ns <= stages[0].start_ns
        for a, b in zip(stages, stages[1:]):
            assert a.end_ns <= b.start_ns
        assert stages[-1].end_ns <= d.end_ns
        assert all(not rec.children(s) for s in stages)


def test_recording_follows_a_profiler_session(programs):
    program, args = programs["inner_sum"]
    with profile(activities=[ProfilerActivity.CPU]):
        program(*args)
        rec = obs.latest()
        assert rec is not None and rec.by_profiler and not rec.closed
        assert [s.name for s in rec.spans].count("rotate") == ROTATIONS
        assert rec.counters == GLUE["inner_sum"]
    assert obs.latest() is rec and rec.closed
    n = len(rec.spans)
    program(*args)
    assert obs.latest() is rec and len(rec.spans) == n
    with profile(activities=[ProfilerActivity.CPU]):
        program(*args)
    again = obs.latest()
    assert again is not rec and again.closed
    assert [s.name for s in again.spans].count("inner_sum") == 1


def test_chrome_export_has_one_event_a_span(programs, tmp_path):
    program, args = programs["expand_leveled"]
    with obs.recording() as rec:
        program(*args)
    like = tmp_path / "profiler.json"
    base = rec.spans[0].start_ns - 5_000
    like.write_text(json.dumps({"traceEvents": [],
                                "baseTimeNanoseconds": base}))
    for path, want_base in ((tmp_path / "a.json", 0),
                            (tmp_path / "b.json", base)):
        n = obs.export_chrome_trace(str(path),
                                    like=str(like) if want_base else None)
        data = json.loads(path.read_text())
        spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
        assert n == len(rec.spans) == len(spans)
        assert data["baseTimeNanoseconds"] == want_base
        assert all(e["tid"] == obs.HOST_TID for e in spans)
        assert sorted(e["name"] for e in spans) == sorted(
            s.name for s in rec.spans)
        first = next(e for e in spans if e["args"]["id"] == rec.spans[0].id)
        assert first["ts"] == pytest.approx(
            (rec.spans[0].start_ns - want_base) / 1e3)


def test_launch_counter_keeps_its_behaviour_and_a_recording_reads_it():
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())
    kernels.count("ntt")
    with obs.recording() as rec:
        kernels.count("ntt")
        kernels.count("ntt")
        kernels.count("rns_scale")
    kernels.count("ntt")
    assert kernels.LAUNCHES["ntt"] == 4 and kernels.LAUNCHES["rns_scale"] == 1
    assert rec.counters == {"launch.ntt": 2, "launch.rns_scale": 1}
    kernels.reset_launches()
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    assert not any(kernels.LAUNCHES.values())


def test_a_plain_kernel_version_is_not_counted_as_glue():
    """On the CPU the plain transform stands for K1: its elementwise work
    is the kernel's, and only the add after it is glue."""
    ctx = bfv_params(DEGREE, 65537, [62, 62]).context_at_level(0)
    x = torch.arange(2 * DEGREE, dtype=torch.int64).reshape(2, DEGREE)
    with obs.recording() as rec:
        y = ntt_forward(ctx, x)
        ctx.add(y, y)
    assert rec.counters == {"glue.zq.add": 1}


def test_decorator_and_timeit_use_the_one_tracer(caplog):
    @obs.span("decorated")
    def work():
        return 7

    assert work() == 7
    report = {}
    with obs.recording() as rec:
        assert work() == 7
        with caplog.at_level(logging.INFO, logger="tpufhe_torch"):
            with obs.timeit("block", report, "block_s"):
                pass
    assert [s.name for s in rec.spans] == ["decorated", "block"]
    assert report["block_s"] == rec.spans[1].seconds >= 0
    assert any("block:" in r.getMessage() for r in caplog.records)
    with obs.timeit("quiet", report):
        pass
    assert "quiet" in report and len(rec.spans) == 2
