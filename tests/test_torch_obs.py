"""The port's tracer (tpufhe_torch.utils.obs) on the CPU: off, it records
nothing and the programs' outputs are those of a recorded run; on, spans
nest by parent id, the expansion's doublings are tiled by their three
stages, the glue counters read what the code issues, recording follows a
torch.profiler session, the Chrome export holds one event a span, and the
kernels' launch counter keeps its behaviour."""

import contextlib
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
from tpufhe_torch.bfv import Ciphertext
from tpufhe_torch.bfv.ops import ct_mul_pt
from tpufhe_torch.ops.rq import ntt_forward
from tpufhe_torch.pipeline import (
    encode_pir_database,
    make_expand,
    make_inner_sum,
    make_mul_relin,
    make_pir_response_db,
)
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


# the products (glue.zq.mul and glue.zq.mul_shoup, one zq_mul launch each
# on the card) of what the benchmark's glue-bound cells serve, at degree
# 128: a MulPIR batch of 16 (mulpir-q16: moduli of 50, 55 and 55 bits,
# queries at level 1, expansion keys at level 0, seven doublings of 12 glue
# calls, 3 of them Shoup products, then the response and its switch to
# the last level, one switch-down of 3 calls) and the inner-product step's
# product by the plaintext weights (innerprod-b64: a two-part ciphertext
# over 4 x 62 bits)
MULPIR_LEVELS = 7
MULPIR_GLUE = {"glue.rq.substitute": 2 * MULPIR_LEVELS,
               "glue.zq.add": 4 * MULPIR_LEVELS + 1,
               "glue.zq.sub": 3 * MULPIR_LEVELS + 1,
               "glue.zq.mul_shoup": 3 * MULPIR_LEVELS + 1,
               "rq.switch_down": MULPIR_LEVELS + 1}


def served_programs(batch: int = 16, respond: bool = True) -> dict:
    """{name: a call of no arguments returning the outputs' tensors}: the
    MulPIR batch and the inner-product step's ct_mul_pt above; without
    `respond`, the batch's expansion is switched to the last level as it
    comes (its first ciphertext), with no response in between."""
    from tpufhe_torch.bfv import RelinearizationKey

    rng = ChaCha8Rng(seed_from_u64(20))
    par = bfv_params(128, 1785857, [50, 55, 55])
    sk = SecretKey.random(par, rng)
    ek = (EvaluationKeyBuilder(sk, ciphertext_level=1,
                               evaluation_key_level=0)
          .enable_expansion(MULPIR_LEVELS).build(rng))
    rk = RelinearizationKey.new(sk, rng, ciphertext_level=1, key_level=1)
    cts = [sk.try_encrypt(Plaintext.try_encode([i + 1, 0, 2], Encoding.poly(1),
                                               par), rng)
           for i in range(batch)]
    c0 = torch.stack([ct[0] for ct in cts])
    c1 = torch.stack([ct[1] for ct in cts])
    dims = (3, 2)
    values = torch.arange(6 * 128, dtype=torch.int64).reshape(6, 128) % 997
    db = encode_pir_database(par, values, Encoding.poly(1)).reshape(
        *dims, 2, 128)
    expand = make_expand(par, ek, MULPIR_LEVELS, level=1)
    response = make_pir_response_db(par, rk, *dims, level=1)

    def mulpir_batch():
        e0, e1 = expand(c0, c1)
        parts = (list(response(e0, e1, db)) if respond
                 else [e0[0], e1[0]])
        res = Ciphertext(par, parts, 1)
        res.switch_to_level(res.max_switchable_level())
        return res.c

    ring = bfv_params(128, 65537, [62] * 4)
    sk4 = SecretKey.random(ring, rng)
    ct = sk4.try_encrypt(Plaintext.try_encode(list(range(128)),
                                              Encoding.simd(), ring), rng)
    weights = Plaintext.try_encode(list(range(1, 129)), Encoding.simd(), ring)
    return {"mulpir_batch": mulpir_batch,
            "ct_mul_pt": lambda: ct_mul_pt(ct, weights).c}


@contextlib.contextmanager
def one_torch_thread():
    """torch on one host thread for the block: the served programs' large
    elementwise chains slow down tens of times when every test worker
    runs them on all the cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    return served_programs()


def test_served_programs_issue_the_cells_products(served):
    """87 glue calls a MulPIR batch of 16, 22 of them Shoup products (the
    cell's 5.4375 a query); 2 Barrett products an inner-product step."""
    with one_torch_thread(), obs.recording() as rec:
        served["mulpir_batch"]()
    assert rec.counters == MULPIR_GLUE
    assert sum(n for k, n in rec.counters.items()
               if k.startswith("glue.")) == 87
    with obs.recording() as rec:
        served["ct_mul_pt"]()
    assert rec.counters == {"glue.zq.mul": 2}


def test_the_kernel_wrapper_raises_off_the_card():
    """zq.mul_cuda takes CUDA tensors only; zq.mul and zq.mul_shoup on CPU
    tensors run the digit chains and launch nothing."""
    from tpufhe_torch.ops import zq

    ctx = bfv_params(DEGREE, 65537, [62, 62]).context_at_level(0)
    x = torch.arange(2 * DEGREE, dtype=torch.int64).reshape(2, DEGREE)
    with pytest.raises(ValueError):
        zq.mul_cuda(x, x, None, ctx.mod)
    b = x[:, :1] + 1
    bs = torch.from_numpy(zq.as_int64(zq.shoup_array(b.numpy(), ctx.moduli)))
    kernels.reset_launches()
    assert torch.equal(zq.mul(x, x, ctx.mod), zq.mul_plain(x, x, ctx.mod))
    assert torch.equal(zq.mul_shoup(x, b, bs, ctx.mod),
                       zq.mul_shoup_plain(x, b, bs, ctx.mod))
    assert kernels.LAUNCHES["zq_mul"] == 0
