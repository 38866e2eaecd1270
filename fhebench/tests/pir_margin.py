"""How much noise budget MulPIR's answers keep at the last level, with
fhe.rs's database and with one of full entropy, and whether the
reference's own server (reference/pir.py) gives the program's answers
word for word.

    python -m fhebench.tests.pir_margin --seed S [--reference K]

On the card, at the mulpir cells' configuration: the program serves each
query of the pool once against each database; every answer is parsed,
decrypted by the reference's secret key and compared with its row
(wrong coefficients) and its noise measured (bits left: log2(q0 / 2t)
less log2 of the largest error). Then the reference works out again the
answers to the K queries that keep the least budget against the database
of full entropy and compares them with the program's word for word. One
JSON line per query and per reference answer.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from fhebench.reference import bfv, pir
from fhebench.run import resolve
from fhebench.trace import Recorder
from fhebench.traffic import common, mulpir


def full_database(config: dict, seed: int) -> np.ndarray:
    """Elements of full entropy: random bytes from the seed."""
    return common.data_rng(seed, 5).integers(
        0, 256, (config["database_size"], config["element_size"]),
        dtype=np.uint8)


def serve_all(config, mix, seed, device, db) -> list:
    """The program's answer bytes to every query of the pool, `db` in
    place of fhe.rs's database."""
    orig = mulpir.database
    mulpir.database = lambda config: db
    try:
        cell = mulpir.setup(config, mix, seed, device)
    finally:
        mulpir.database = orig
    out = [cell.serve([q], Recorder(False))[0] for q in cell.queries]
    cell.free()
    return out


def margins(config, mix, seed, device=None, reference=1, emit=print):
    par = common.reference_params(config)
    per, dim1, dim2, _ = mulpir.layout(config)
    lvl, last = config["query_level"], len(config["moduli_sizes"]) - 1
    room = math.log2(par.moduli[0] / (2 * par.plaintext))
    indices = mulpir.query_indices(config, mix, seed)
    rep = bfv.Replay(par, seed)
    gk, rk = mulpir.replay_keys(config, rep)
    queries = [rep.encryption(mulpir.query_plaintext(config, int(i)), lvl)
               for i in indices]
    out = {}
    for name, db in (("fhe.rs", mulpir.database(config)),
                     ("full", full_database(config, seed))):
        answers = serve_all(config, mix, seed, device, db)
        rows = []
        for a, data in enumerate(answers):
            parts, level, _ = bfv.parse_ciphertext(par, data)
            row = bfv.pir_row_values(par, db, int(indices[a]) // per)
            got = rep.decrypt(parts[0], parts[1], level, ntt=False)
            left = room - pir.noise_bits(rep, parts[0], parts[1], row, level)
            rows.append((left, a, parts))
            emit(json.dumps({"database": name, "seed": seed, "query": a,
                             "level": level,
                             "wrong": int((got != row).sum()),
                             "bits_left": round(left, 3)}))
        out[name] = rows
    for left, a, parts in sorted(out["full"], key=lambda r: r[0])[:reference]:
        db = full_database(config, seed)
        t0 = time.perf_counter()
        want = pir.answer(par, rep, gk, rk, queries[a][:2],
                          lambda r: bfv.pir_row_values(par, db, r),
                          (dim1, dim2), lvl, config["expansion_key_level"])
        row = bfv.pir_row_values(par, db, int(indices[a]) // per)
        mine = rep.decrypt(want[0], want[1], last, ntt=False)
        emit(json.dumps({
            "reference_answer": a, "seed": seed,
            "words_off": common.words_off(parts[0], want[0])
            + common.words_off(parts[1], want[1]),
            "wrong": int((mine != row).sum()),
            "bits_left": round(room - pir.noise_bits(rep, want[0], want[1],
                                                     row, last), 3),
            "seconds": round(time.perf_counter() - t0, 1)}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fhebench.tests.pir_margin")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reference", type=int, default=1)
    args = ap.parse_args(argv)
    _, _, config, mix = resolve("mulpir-q16")
    margins(config, mix, args.seed, None, args.reference,
            emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
