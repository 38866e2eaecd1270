"""The port's native ChaCha8 / uniform / CBD sampler: for the same seed the
native and the pure-Python streams of tpufhe_torch are equal to each other
and to tpufhe's, across block boundaries and mixed draws."""

import numpy as np
import pytest

from tpufhe.utils import rngs as jrngs
from tpufhe.utils.sampling import sample_vec_cbd as j_cbd

from tpufhe_torch import native
from tpufhe_torch.utils import rngs
from tpufhe_torch.utils.sampling import sample_vec_cbd

P62 = (1 << 62) - 57


def _draws(mod_rngs, cbd, seed):
    """A mixed sequence of draws: unaligned and block-crossing fills,
    uniform values, CBD errors (aligned and after an unaligned fill)."""
    r = mod_rngs.ChaCha8Rng(mod_rngs.seed_from_u64(seed))
    out = [r.fill_bytes(5), r.fill_bytes(32)]
    out.append(mod_rngs.uniform_u64_below(r, P62, 37).tolist())
    out.append(r.fill_bytes(200))
    out.append(cbd(100, 10, r).tolist())
    out.append(mod_rngs.uniform_u64_below(r, 65537, 300).tolist())
    out.append(r.fill_bytes(3))
    out.append(cbd(17, 3, r).tolist())
    out.append(r.fill_bytes(64 * 5 + 7))
    out.append(r.next_u64())
    out.append(cbd(1000, 16, r).tolist())
    return out


@pytest.mark.parametrize("seed", [0, 2026, (1 << 64) - 1])
def test_native_and_pure_streams_match_tpufhe(seed, monkeypatch):
    assert native.lib() is not None, native.error
    got_native = _draws(rngs, sample_vec_cbd, seed)
    want = _draws(jrngs, j_cbd, seed)
    monkeypatch.setattr(native, "lib", lambda: None)
    got_pure = _draws(rngs, sample_vec_cbd, seed)
    assert got_native == want
    assert got_pure == want


def test_native_library_is_the_ports_own_build():
    lib = native.lib()
    assert lib is not None, native.error
    assert "tpufhe_torch" in lib._name and lib._name.endswith(".so")
    assert np.all(np.asarray(
        rngs.uniform_u64_below(rngs.ChaCha8Rng(bytes(32)), 7, 64)) < 7)
