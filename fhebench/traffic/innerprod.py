"""Encrypted inner products: a batch of encrypted SIMD vectors, each
multiplied by the server's plaintext weight vector (bfv.ops.ct_mul_pt)
and summed over its slots (pipeline.make_inner_sum: the column rotations
by 1, 2, 4, ..., N/4 and the row rotation, each with its add), as in
private scoring, where an encrypted feature vector meets a plaintext
model.

Set-up: the secret key and the inner-sum Galois keys from the seed,
`pool` batches of `batch` encryptions of seeded SIMD vectors, and the
weight vector, drawn from the seed and SIMD-encoded. Step i serves batch
i mod pool; an operation is one encrypted inner product. The window and
the sample of answers are common.BatchedCell's.

The check (after the window): every row of the sampled steps' outputs,
decrypted by the reference's own secret key: every slot must hold the
inner product of the row's vector with the weights mod t (wrong_slots);
the program's secret and Galois keys, and the sampled input encryptions,
compared word by word with the reference's (key_words_off).
"""

from __future__ import annotations

import numpy as np

from fhebench.traffic import common


def messages(config, mix, seed) -> tuple:
    """The (pool, batch, N) slot values of the inputs and the (N,) weights."""
    g = common.data_rng(seed, 0)
    t, n = config["plaintext_modulus"], config["degree"]
    vecs = g.integers(0, t, (mix["pool"], mix["batch"], n), dtype=np.uint64)
    return vecs, g.integers(0, t, n, dtype=np.uint64)


def galois_exponents(n: int) -> list:
    """The inner sum's keys: 3^(2^i) mod 2N for 2^i < N/2, and 2N - 1."""
    return sorted({pow(3, 1 << i, 2 * n) for i in range(n.bit_length() - 2)}
                  | {2 * n - 1})


class Cell(common.BatchedCell):
    def __init__(self, config, mix, seed, device):
        from tpufhe_torch.bfv import (
            Ciphertext,
            Encoding,
            EvaluationKeyBuilder,
            Plaintext,
            SecretKey,
        )
        from tpufhe_torch.bfv.ops import ct_mul_pt
        from tpufhe_torch.pipeline import make_inner_sum

        self.mix, self.seed = mix, seed
        par = self.par = common.program_params(config, device)
        common.build_kernels(par)
        rng = common.program_rng(seed)
        self.sk = SecretKey.random(par, rng)
        self.ek = EvaluationKeyBuilder(self.sk).enable_inner_sum().build(rng)
        vecs, weights = messages(config, mix, seed)
        self.c0, self.c1 = common.encrypt_batches(self.sk, vecs, rng)
        self.weights = Plaintext.try_encode(weights, Encoding.simd(), par)
        inner_sum = make_inner_sum(par, self.ek)

        def step(c0, c1):
            prod = ct_mul_pt(Ciphertext(par, [c0, c1], 0), self.weights)
            return inner_sum(prod[0], prod[1])

        self.step = step
        self.start_sample()

    def inputs_of(self, i: int) -> list:
        return [i % self.mix["pool"]]

    def run_step(self, i: int):
        a = i % self.mix["pool"]
        return self.step(self.c0[a], self.c1[a])

    def keys(self) -> dict:
        words = common.words
        return {"gk": {e: (words(g.ksk.c0), words(g.ksk.c1))
                       for e, g in self.ek.gk.items()}}


def setup(config, mix, seed, device=None) -> Cell:
    return Cell(config, mix, seed, device)


def check(config, mix, seed, ans) -> dict:
    """The reference's verdict on a run's answers (see the module)."""
    from fhebench.reference import bfv

    par = common.reference_params(config)
    t, n = config["plaintext_modulus"], config["degree"]
    vecs, weights = messages(config, mix, seed)
    rep = bfv.Replay(par, seed)
    off = common.words_off(ans["sk"].astype(np.int64), rep.s)
    off += common.keys_off(ans["gk"], {e: rep.galois_key(e, 0, 0)
                                       for e in galois_exponents(n)})
    off += common.inputs_off(rep, ans["inputs"], mix["batch"],
                             lambda j, r: bfv.simd_encode(par, vecs[j, r]))
    wrong = 0
    for i, o0, o1 in ans["steps"]:
        a = i % mix["pool"]
        slots = bfv.simd_decode(par, rep.decrypt(o0, o1, 0))
        want = (vecs[a].astype(object) * weights).sum(axis=1) % t
        wrong += int((slots != want.astype(np.uint64)[:, None]).sum())
    return common.checks(mix, {"wrong_slots": wrong, "key_words_off": off})
