"""The plain NTT of tpufhe_torch (the CPU side of kernel K1) against tpufhe's
jitted ntt_forward_any / ntt_backward_any, word for word."""

import jax
import numpy as np
import pytest
import torch

import tpufhe.bfv as J
from tpufhe.ops.rq import Context as JContext
from tpufhe.ops.rq import ntt_backward_any, ntt_forward_any

from tpufhe_torch import convert
from tpufhe_torch.ops.rq import Context, ntt_backward, ntt_forward


def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, shape, dtype=np.uint64) for p in moduli],
                 axis=-2)
    x[0] = np.array(moduli, dtype=np.uint64)[:, None] - 1  # all (p - 1)
    return x.astype(np.int64)


@pytest.mark.parametrize("n", [1024, 8192])
def test_ntt_matches_tpufhe(n):
    moduli = J.BfvParametersBuilder.generate_moduli([62, 62, 62], n)
    jctx = JContext(tuple(moduli), n)
    tctx = Context(moduli, n, "cpu")
    x = _residues(moduli, (2, n), n)
    lanes = convert.words_to_lanes(x)
    xt = torch.from_numpy(x)

    fwd = jax.jit(lambda a: ntt_forward_any(jctx, a, in_bits=62))(lanes)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(fwd)),
                                  ntt_forward(tctx, xt).numpy())
    bwd = jax.jit(lambda a: ntt_backward_any(jctx, a, in_bits=62))(lanes)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(bwd)),
                                  ntt_backward(tctx, xt).numpy())

    # limb_slice: limbs 1..3 of the context, as the extend stage uses it
    sl = slice(1, 3)
    part = lanes[:, sl]
    fsl = jax.jit(lambda a: ntt_forward_any(jctx, a, limb_slice=sl,
                                            in_bits=62))(part)
    got = ntt_forward(tctx, xt[:, sl].contiguous(), limb_slice=sl)
    np.testing.assert_array_equal(convert.lanes_to_words(np.asarray(fsl)),
                                  got.numpy())


def test_ntt_round_trip_and_canonical():
    n = 1024
    moduli = J.BfvParametersBuilder.generate_moduli([62, 62], n)
    tctx = Context(moduli, n, "cpu")
    xt = torch.from_numpy(_residues(moduli, (3, n), 5))
    f = ntt_forward(tctx, xt)
    p = torch.tensor(moduli)[:, None]
    assert bool(((f >= 0) & (f < p)).all())
    assert torch.equal(ntt_backward(tctx, f), xt)
