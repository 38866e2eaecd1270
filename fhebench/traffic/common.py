"""What the drivers share: the program's parameters built from a
configuration file, the seeded streams of a run, the reservoir that keeps
a seeded sample of the window's answers, the comparisons of keys and
inputs, and the cell whose window runs steps over batches of
encryptions."""

from __future__ import annotations

import time

import numpy as np

#: the window checks the clock after this many enqueued steps, each check
#: a synchronize
SYNC_EVERY = 8


def program_params(config: dict, device):
    """The program's BfvParameters of a configuration file."""
    from tpufhe_torch.bfv import BfvParametersBuilder

    return (BfvParametersBuilder().set_degree(config["degree"])
            .set_plaintext_modulus(config["plaintext_modulus"])
            .set_moduli_sizes(config["moduli_sizes"])
            .set_variance(config["variance"]).set_device(device).build())


def reference_params(config: dict):
    from fhebench.reference.bfv import Params

    return Params(config["degree"], config["plaintext_modulus"],
                  tuple(config["moduli_sizes"]), config["variance"])


def program_rng(seed: int):
    """The program's ChaCha8 stream of a run: keys, encryptions."""
    from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64

    return ChaCha8Rng(seed_from_u64(seed))


def data_rng(seed: int, purpose: int) -> np.random.Generator:
    """The benchmark's own stream for messages, indices and samples."""
    return np.random.default_rng([seed, purpose])


def build_kernels(par) -> None:
    """Build or load every kernel of the program at once (one nvcc per
    kernel, in parallel, only where the checkout has none built)."""
    if par.device.type == "cuda":
        from tpufhe_torch import kernels

        kernels.build()


def sync(par) -> None:
    if par.device.type == "cuda":
        import torch

        torch.cuda.synchronize(par.device)


class Reservoir:
    """A uniform sample of `size` of the window's answers, drawn from the
    seed (reservoir sampling): offer(i, make) keeps make() for answer i
    when it is drawn."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = size
        self.rng = rng
        self.kept: dict = {}

    def offer(self, i: int, make) -> None:
        if len(self.kept) < self.size:
            self.kept[i] = make()
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = make()


def words(t) -> np.ndarray:
    """A program tensor of residues as uint64 on the host."""
    return t.detach().cpu().numpy().astype(np.uint64)


def words_off(got: np.ndarray, want: np.ndarray) -> int:
    """How many words differ (all of them where the shapes differ)."""
    if got.shape != want.shape:
        return int(max(got.size, want.size))
    return int((got != want).sum())


def keys_off(got: dict, want: dict) -> int:
    """Words of the program's keys {name: (c0, c1)} that differ from the
    reference's; a key on one side only counts all its words."""
    off = 0
    for name in set(got) | set(want):
        g, w = got.get(name), want.get(name)
        if g is None or w is None:
            off += sum(x.size for x in (g if w is None else w))
        else:
            off += words_off(g[0], w[0]) + words_off(g[1], w[1])
    return off


def checks(mix: dict, values: dict) -> dict:
    """{name: {value, limit}} with the mix's limits."""
    return {k: {"value": v, "limit": mix["limits"][k]}
            for k, v in values.items()}


def inputs_off(rep, inputs: dict, batch: int, plaintext) -> int:
    """Words of a run's sampled input encryptions {(j, r): (c0, c1)} that
    differ from the reference's: row r of batch j is the run's encryption
    number j * batch + r, of the plaintext polynomial plaintext(j, r)."""
    off = done = 0
    for j, r in sorted(inputs, key=lambda jr: jr[0] * batch + jr[1]):
        rep.skip_encryptions(j * batch + r - done)
        want = rep.encryption(plaintext(j, r), 0)
        got = inputs[(j, r)]
        off += words_off(got[0], want[0]) + words_off(got[1], want[1])
        done = j * batch + r + 1
    return off


class BatchedCell:
    """A cell whose step i runs the program over whole batches of
    encryptions, `pool` batches of `batch` held as self.c0, self.c1 of
    shape (pool, batch, ...). A driver sets self.par, mix, seed, sk, c0,
    c1 and step, calls start_sample(), and says which batches step i
    reads (inputs_of) and which key words the check compares (keys).

    The window enqueues steps back to back and synchronizes every
    SYNC_EVERY of them to read the clock; an operation is one row of a
    step. The answers are every row of a seeded sample of `check_steps`
    steps' outputs, with the inputs of `check_rows` rows of each, drawn
    from both halves of the batch."""

    def inputs_of(self, i: int) -> list:
        raise NotImplementedError

    def run_step(self, i: int):
        raise NotImplementedError

    def keys(self) -> dict:
        return {}

    def start_sample(self) -> None:
        self.on_card = self.par.device.type == "cuda"
        self.sample = Reservoir(self.mix["check_steps"],
                                data_rng(self.seed, 1))

    def warm(self) -> None:
        for i in range(2):
            self.run_step(i)
        sync(self.par)

    def window(self, seconds: float, rec) -> None:
        i = 0
        t0 = time.perf_counter()
        with rec.span("steps"):
            while True:
                out = self.run_step(i)
                self.sample.offer(i, lambda: (out[0].clone(), out[1].clone()))
                i += 1
                if i % SYNC_EVERY == 0:
                    sync(self.par)
                    if time.perf_counter() - t0 >= seconds:
                        break
        rec.window.ops = rec.window.attempted = i * self.mix["batch"]

    def answers(self) -> dict:
        pick = data_rng(self.seed, 2)
        batch, per = self.mix["batch"], self.mix["check_rows"]
        half = batch // 2
        out = {"sk": self.sk.coeffs.copy(), "steps": [], "inputs": {},
               **self.keys()}
        for i in sorted(self.sample.kept):
            o0, o1 = self.sample.kept[i]
            rows = np.concatenate([
                pick.choice(half, per // 2, replace=False),
                half + pick.choice(batch - half, per - per // 2,
                                   replace=False)])
            out["steps"].append((i, words(o0), words(o1)))
            for j in self.inputs_of(i):
                for r in rows:
                    out["inputs"][(j, int(r))] = (words(self.c0[j, r]),
                                                  words(self.c1[j, r]))
        return out

    def free(self) -> None:
        vars(self).clear()


def encrypt_batches(sk, msgs: np.ndarray, rng) -> tuple:
    """(c0, c1) of shape (pool, batch, ...): the SIMD encryptions of the
    (pool, batch, N) slot values, in that order from the stream rng."""
    import torch

    from tpufhe_torch.bfv import Encoding, Plaintext

    parts = [[], []]
    for batch in msgs:
        cts = [sk.try_encrypt(Plaintext.try_encode(
            row, Encoding.simd(), sk.par), rng) for row in batch]
        for j in (0, 1):
            parts[j].append(torch.stack([ct[j] for ct in cts]))
    return torch.stack(parts[0]), torch.stack(parts[1])
