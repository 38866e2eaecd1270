"""A batch of ciphertexts multiplied and relinearized, step after step
(pipeline.make_mul_relin), as a server evaluates a depth-one circuit over
many clients' ciphertexts.

Set-up: the secret and relinearization keys from the seed, `pool` batches
of `batch` encryptions of seeded SIMD messages. Step i multiplies batch
i mod pool by batch (i + 1) mod pool; an operation is one ciphertext
multiplied and relinearized. The window and the sample of answers are
common.BatchedCell's.

The check (after the window): every row of the sampled steps' outputs,
decrypted by the reference's own secret key and compared slot by slot
with the products of the messages (wrong_slots); the program's secret
and relinearization keys, and the sampled input encryptions, compared
word by word with the reference's (key_words_off).
"""

from __future__ import annotations

import numpy as np

from fhebench.traffic import common


class Cell(common.BatchedCell):
    def __init__(self, config, mix, seed, device):
        from tpufhe_torch.bfv import RelinearizationKey, SecretKey
        from tpufhe_torch.pipeline import make_mul_relin

        self.mix, self.seed = mix, seed
        par = self.par = common.program_params(config, device)
        common.build_kernels(par)
        rng = common.program_rng(seed)
        self.sk = SecretKey.random(par, rng)
        self.rk = RelinearizationKey.new(self.sk, rng)
        self.c0, self.c1 = common.encrypt_batches(
            self.sk, messages(config, mix, seed), rng)
        self.step = make_mul_relin(par, self.rk)
        self.start_sample()

    def inputs_of(self, i: int) -> list:
        return [i % self.mix["pool"], (i + 1) % self.mix["pool"]]

    def run_step(self, i: int):
        a, b = self.inputs_of(i)
        return self.step(self.c0[a], self.c1[a], self.c0[b], self.c1[b])

    def keys(self) -> dict:
        return {"rk": (common.words(self.rk.ksk.c0),
                       common.words(self.rk.ksk.c1))}


def messages(config, mix, seed) -> np.ndarray:
    """The (pool, batch, N) slot values of the inputs, from the seed."""
    return common.data_rng(seed, 0).integers(
        0, config["plaintext_modulus"],
        (mix["pool"], mix["batch"], config["degree"]), dtype=np.uint64)


def setup(config, mix, seed, device=None) -> Cell:
    return Cell(config, mix, seed, device)


def check(config, mix, seed, ans) -> dict:
    """The reference's verdict on a run's answers (see the module)."""
    from fhebench.reference import bfv

    par = common.reference_params(config)
    t = config["plaintext_modulus"]
    msgs = messages(config, mix, seed)
    rep = bfv.Replay(par, seed)
    off = common.words_off(ans["sk"].astype(np.int64), rep.s)
    off += common.keys_off({"rk": ans["rk"]}, {"rk": rep.relin_key(0)})
    off += common.inputs_off(rep, ans["inputs"], mix["batch"],
                             lambda j, r: bfv.simd_encode(par, msgs[j, r]))
    wrong = 0
    for i, o0, o1 in ans["steps"]:
        a, b = i % mix["pool"], (i + 1) % mix["pool"]
        slots = bfv.simd_decode(par, rep.decrypt(o0, o1, 0))
        wrong += int((slots != msgs[a] * msgs[b] % np.uint64(t)).sum())
    return common.checks(mix, {"wrong_slots": wrong, "key_words_off": off})
