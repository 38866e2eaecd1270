"""The port's example applications against tpufhe's, on the CPU: the
walkthroughs' result dicts equal (values, noise and wire sizes), and
MulPIR and SealPIR at degree 64 with 32 elements of 8 bytes, through both
of the port's server paths (the programs and the object API), retrieve
tpufhe's element with every *_bytes report entry equal to tpufhe's. Also
the database helpers (the plaintexts equal tpufhe's encode_database), the
CLI and the multiparty voting example. tpufhe runs its object path on the
CPU."""

import os

import jax  # noqa: F401  (tpufhe's backend, on the CPU here)
import numpy as np
import pytest

from tpufhe import models as jmodels
from tpufhe.bfv import BfvParametersBuilder as JBuilder
from tpufhe.models import util as jutil

from tpufhe_torch import models
from tpufhe_torch.bfv import BfvParametersBuilder
from tpufhe_torch.models import pir, util

PIR_ARGS = dict(database_size=32, elements_size=8, degree=64)


@pytest.mark.parametrize("name", ["run_bfv_basic", "run_bfv_ops",
                                  "run_rgsw"])
def test_walkthroughs_match_tpufhe(name):
    want = getattr(jmodels, name)(num_moduli=3, degree=16)
    got = getattr(models, name)(num_moduli=3, degree=16, device="cpu")
    assert got == want
    for key, value in got.items():
        if isinstance(value, tuple) and key != "noise_bits" and key != "bytes":
            assert value[0] == value[1], key


@pytest.mark.parametrize("kwargs", [
    {}, dict(num_voters=40, num_parties=5, degree=32, seed=11)],
    ids=["defaults", "40x5"])
def test_voting_matches_tpufhe(kwargs):
    """run_voting's tally and expected tally equal tpufhe's (the same
    ballots from np.random.default_rng(seed), the same ChaCha8 stream)."""
    want = jmodels.run_voting(**kwargs)
    got = models.run_voting(device="cpu", **kwargs)
    assert got == want
    assert got[0] == got[1]


@pytest.fixture(scope="module")
def reference():
    """tpufhe's runs, each (answer, expected, report), on its object path."""
    assert os.environ.get("TPUFHE_PIR_FUSED", "") == ""
    out = {}
    for scheme in ("mulpir", "sealpir"):
        report = {}
        answer, expected = getattr(jmodels, f"run_{scheme}")(
            report=report, **PIR_ARGS)
        out[scheme] = (answer, expected, report)
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["programs", "objects"])
@pytest.mark.parametrize("scheme", ["mulpir", "sealpir"])
def test_pir_matches_tpufhe(reference, scheme, fused):
    j_answer, j_expected, j_report = reference[scheme]
    report = {}
    kwargs = dict(report=report, fused=fused, device="cpu", **PIR_ARGS)
    if scheme == "mulpir":
        kwargs["repeat"] = 2
    answer, expected = getattr(pir, f"run_{scheme}")(**kwargs)
    assert answer == expected == j_answer == j_expected
    assert report["dims"] == j_report["dims"]
    sizes = {k: v for k, v in report.items() if k.endswith("_bytes")}
    assert sizes == {k: v for k, v in j_report.items() if k.endswith("_bytes")}
    assert sizes
    if scheme == "mulpir":
        index = int(np.random.default_rng(17).integers(0, 32))
        assert report["warm_index"] == (index + 1) % 32
        assert {"expand_warm_s", "response_warm_s"} <= set(report)


@pytest.mark.parametrize("size, elements", [(32, 8), (100, 3), (7, 1)])
def test_database_helpers_match_tpufhe(size, elements):
    db = util.generate_database(size, elements)
    assert [bytes(r) for r in db] == jutil.generate_database(size, elements)
    jpar = (JBuilder().set_degree(64).set_plaintext_modulus(65537)
            .set_moduli_sizes([50, 55, 55]).build())
    tpar = (BfvParametersBuilder().set_degree(64).set_plaintext_modulus(65537)
            .set_moduli_sizes([50, 55, 55]).set_device("cpu").build())
    jpts, jdims = jutil.encode_database(jutil.generate_database(size, elements),
                                        jpar, 1)
    tpts, tdims = util.encode_database(db, tpar, 1)
    assert tdims == jdims and len(tpts) == len(jpts)
    for jp, tp in zip(jpts, tpts):
        np.testing.assert_array_equal(tp.value, jp.value)
        assert (tp.level, tp.encoding.encoding, tp.encoding.level) == (
            jp.level, jp.encoding.encoding, jp.encoding.level)
        np.testing.assert_array_equal(
            tp.poly_ntt.numpy(),
            jp.poly_ntt.to_u64_matrix().astype(np.int64))


@pytest.mark.parametrize("scheme", ["mulpir", "sealpir"])
def test_cli_runs_on_the_cpu(scheme, capsys):
    rc = pir.main(["--scheme", scheme, "--database-size", "32",
                   "--element-size", "8", "--degree", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out and "query_bytes" in out
