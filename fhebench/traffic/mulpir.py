"""A MulPIR server (fhe.rs examples/mulpir.rs; the port's models/pir.py
serve path) answering a closed loop of queries: `batch` queries at a time,
the next batch sent when the last answer's bytes are out.

Set-up: the secret key, the expansion keys (level 0, for ciphertexts at
the query's level 1) and the relinearization key (level 1) from the seed,
in models/pir.py's order; the database of `database_size` elements of
`element_size` bytes as fhe.rs's examples make it, transcoded into
plaintext rows
and encoded on the card at level 1 (encode_pir_database, resident); a
pool of `pool` client queries, each for an index drawn from the seed,
encrypted and serialized by the client outside the window.

A query's server path, timed from its bytes to its answer's bytes:
Ciphertext.from_bytes, make_expand, make_pir_response_db on the resident
database, switch_to_level to the last level, to_bytes. A batch stacks its
queries on the programs' batch axis.

The check (after the window): a seeded sample of `check_queries` of the
window's answers, parsed and decrypted by the reference's own secret key,
each compared coefficient by coefficient with the plaintext row that
holds its element, an answer that is not a two-part ciphertext at the
last level counting all its coefficients (wrong_values); the program's secret key, expansion
and relinearization keys and the sampled queries' bytes compared word by
word with the reference's (key_words_off).
"""

from __future__ import annotations

import time

import numpy as np

from fhebench.traffic import common


def database(config: dict) -> np.ndarray:
    """The (elements, element_size) bytes of the database as fhe.rs's
    examples make it (examples/util.rs generate_database): element i holds
    i as four little-endian bytes, then zeros. Elements of full entropy
    leave the answer too little noise budget at the last level (PERF.md)."""
    count, size = config["database_size"], config["element_size"]
    db = np.zeros((count, size), dtype=np.uint8)
    head = np.arange(count, dtype="<u4").view(np.uint8).reshape(count, 4)
    db[:, :min(4, size)] = head[:, :min(4, size)]
    return db


def layout(config: dict) -> tuple:
    """(elements a plaintext row, dim1, dim2, expansion levels)."""
    nbits = config["plaintext_modulus"].bit_length() - 1
    per = nbits * config["degree"] // (config["element_size"] * 8)
    rows = -(-config["database_size"] // per)
    dim1 = int(np.ceil(np.sqrt(rows)))
    dim2 = -(-rows // dim1)
    return per, dim1, dim2, (dim1 + dim2 - 1).bit_length()


def query_indices(config: dict, mix: dict, seed: int) -> np.ndarray:
    return common.data_rng(seed, 3).integers(0, config["database_size"],
                                             mix["pool"])


def query_plaintext(config: dict, index: int) -> np.ndarray:
    """The client's selection vector for element `index`: (2^L)^-1 mod t
    at the two selectors of its row's cell (models/pir.py)."""
    t = config["plaintext_modulus"]
    per, dim1, dim2, level = layout(config)
    row = index // per
    pt = np.zeros(dim1 + dim2, dtype=np.uint64)
    inv = pow(1 << level, -1, t)
    pt[row // dim2] = inv
    pt[dim1 + row % dim2] = inv
    return pt


class Cell:
    def __init__(self, config, mix, seed, device):
        from tpufhe_torch.bfv import (
            Encoding,
            EvaluationKeyBuilder,
            Plaintext,
            RelinearizationKey,
            SecretKey,
        )
        from tpufhe_torch.models.util import database_rows
        from tpufhe_torch.pipeline import (
            encode_pir_database,
            make_expand,
            make_pir_response_db,
        )

        self.config, self.mix, self.seed = config, mix, seed
        par = self.par = common.program_params(config, device)
        self.on_card = par.device.type == "cuda"
        common.build_kernels(par)
        lvl = config["query_level"]
        _, dim1, dim2, level = layout(config)
        rng = common.program_rng(seed)
        self.sk = SecretKey.random(par, rng)
        self.ek = (EvaluationKeyBuilder(
            self.sk, ciphertext_level=lvl,
            evaluation_key_level=config["expansion_key_level"])
            .enable_expansion(level).build(rng))
        self.rk = RelinearizationKey.new(self.sk, rng, ciphertext_level=lvl,
                                         key_level=config["relin_key_level"])
        values, dims = database_rows(database(config), par)
        assert dims == (dim1, dim2)
        rows = encode_pir_database(par, values, Encoding.poly(lvl))
        self.db = rows.reshape(dim1, dim2, *rows.shape[1:])
        del rows
        self.queries = [self.sk.try_encrypt(Plaintext.try_encode(
            query_plaintext(config, int(i)), Encoding.poly(lvl), par),
            rng).to_bytes() for i in query_indices(config, mix, seed)]
        self.expand = make_expand(par, self.ek, level, level=lvl)
        self.respond = make_pir_response_db(par, self.rk, dim1, dim2,
                                            level=lvl)
        self.sample = common.Reservoir(mix["check_queries"],
                                       common.data_rng(seed, 1))

    def serve(self, batch: list, rec) -> list:
        """The answers' bytes to a batch of queries' bytes."""
        import torch

        from tpufhe_torch.bfv import Ciphertext

        par = self.par
        with rec.span("wire_in"):
            cts = [Ciphertext.from_bytes(q, par) for q in batch]
            c0 = torch.stack([ct[0] for ct in cts])
            c1 = torch.stack([ct[1] for ct in cts])
        with rec.span("expand"):
            e0, e1 = self.expand(c0, c1)
            common.sync(par)
        with rec.span("response"):
            o0, o1 = self.respond(e0, e1, self.db)
            res = Ciphertext(par, [o0, o1], self.config["query_level"])
            res.switch_to_level(res.max_switchable_level())
            common.sync(par)
        with rec.span("wire_out"):
            out = [Ciphertext(par, [x[j] for x in res.c],
                              res.level).to_bytes()
                   for j in range(len(batch))]
        return out

    def warm(self) -> None:
        from fhebench.trace import Recorder

        self.serve(self.queries[: self.mix["batch"]], Recorder(False))

    def window(self, seconds: float, rec) -> None:
        w = rec.window
        b, pool = self.mix["batch"], self.mix["pool"]
        i = 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            at = [(i + j) % pool for j in range(b)]
            t0 = time.perf_counter()
            with rec.span("query"):
                answers = self.serve([self.queries[a] for a in at], rec)
            w.latencies_ms.append((time.perf_counter() - t0) * 1e3)
            for j, a in enumerate(at):
                self.sample.offer(i + j, lambda a=a, j=j: (a, answers[j]))
            i += b
        w.ops = w.attempted = i

    def answers(self) -> dict:
        from fhebench.traffic.common import words

        gk = {e: (words(g.ksk.c0), words(g.ksk.c1))
              for e, g in self.ek.gk.items()}
        return {"sk": self.sk.coeffs.copy(), "gk": gk,
                "rk": (words(self.rk.ksk.c0), words(self.rk.ksk.c1)),
                "served": sorted(self.sample.kept.values(),
                                 key=lambda ab: ab[0]),
                "queries": {a: self.queries[a]
                            for a, _ in self.sample.kept.values()}}

    def free(self) -> None:
        vars(self).clear()


def setup(config, mix, seed, device=None) -> Cell:
    return Cell(config, mix, seed, device)


def replay_keys(config: dict, rep) -> tuple:
    """The reference's expansion keys {exponent: (c0, c1)} and
    relinearization key, drawn in the set-up's order."""
    lvl, n = config["query_level"], config["degree"]
    level = layout(config)[3]
    gk = {e: rep.galois_key(e, lvl, config["expansion_key_level"])
          for e in sorted({(n >> l) + 1 for l in range(level)})}
    return gk, rep.relin_key(lvl)


def check(config, mix, seed, ans) -> dict:
    """The reference's verdict on a run's answers (see the module)."""
    from fhebench.reference import bfv, ring

    par = common.reference_params(config)
    lvl = config["query_level"]
    per = layout(config)[0]
    rep = bfv.Replay(par, seed)
    off = common.words_off(ans["sk"].astype(np.int64), rep.s)
    n = config["degree"]
    gk, rk = replay_keys(config, rep)
    off += common.keys_off(ans["gk"], gk)
    off += common.keys_off({"rk": ans["rk"]}, {"rk": rk})
    indices = query_indices(config, mix, seed)
    m = par.level_moduli(lvl)
    done = 0
    for a in sorted(ans["queries"]):
        rep.skip_encryptions(a - done)
        c0, _, qseed = rep.encryption(
            query_plaintext(config, int(indices[a])), lvl)
        parts, qlevel, got_seed = bfv.parse_ciphertext(par, ans["queries"][a])
        if qlevel != lvl or len(parts) != 1:
            off += c0.size + 32
        else:
            off += common.words_off(ring.forward(parts[0], m), c0)
            off += 0 if got_seed == qseed else 32
        done = a + 1
    db = database(config)
    last = len(config["moduli_sizes"]) - 1
    wrong = 0
    for a, data in ans["served"]:
        parts, rlevel, _ = bfv.parse_ciphertext(par, data)
        if len(parts) != 2 or rlevel != last:
            wrong += n
            continue
        got = rep.decrypt(parts[0], parts[1], rlevel, ntt=False)
        want = bfv.pir_row_values(par, db, int(indices[a]) // per)
        wrong += int((got != want).sum())
    return common.checks(mix, {"wrong_values": wrong, "key_words_off": off})
