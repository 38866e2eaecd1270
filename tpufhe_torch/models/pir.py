"""Private information retrieval: MulPIR and SealPIR (eprint 2019/1483;
examples/mulpir.rs and examples/sealpir.rs; tpufhe's models/pir.py).

The client encrypts a selection vector scaled by (2^level)^-1; the
server expands it obliviously, takes inner products with the database,
and either multiplies by the second half of the selection (MulPIR, one
ciphertext product and relinearization) or folds the first dimension's
responses into plaintexts for a second inner product (SealPIR).

The server has two paths, equal in their results: on a CUDA device the
programs of pipeline.py (make_expand, then make_pir_response_db or two
make_ct_pt_dot around the host fold), whole batches a launch; on the CPU
the object API, one call per operation, as tpufhe's default path. The
keyword `fused` forces either. The database is encoded and uploaded once,
before the first query and outside its time. `repeat=2` serves a second
query, for element index + 1, warm, checks it and times it (the `*_warm`
entries of the report).

    python -m tpufhe_torch.models.pir [--scheme mulpir|sealpir]
        [--database-size 65536] [--element-size 1024] [--degree 8192]
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.bfv import (
    BfvParametersBuilder,
    Ciphertext,
    Encoding,
    EvaluationKeyBuilder,
    Plaintext,
    PlaintextVec,
    RelinearizationKey,
    SecretKey,
    ct_add,
    ct_mul,
    dot_product_scalar,
)
from tpufhe_torch.models.util import (
    database_rows,
    encode_rows,
    generate_database,
    number_elements_per_plaintext,
)
from tpufhe_torch.pipeline import (
    encode_pir_database,
    make_ct_pt_dot,
    make_expand,
    make_pir_response_db,
)
from tpufhe_torch.utils.misc import inverse
from tpufhe_torch.utils.obs import timeit
from tpufhe_torch.utils.primes import generate_prime
from tpufhe_torch.utils.rngs import ChaCha8Rng, seed_from_u64
from tpufhe_torch.utils.transcode import (
    transcode_bidirectional,
    transcode_to_bytes,
)

# the plaintext modulus of examples/mulpir.rs:61, 20 bits a coefficient
PAPER_PLAINTEXT = (1 << 20) + (1 << 19) + (1 << 17) + (1 << 16) + (1 << 14) + 1


def _sync(par) -> None:
    """Wait for the card, so a host timer around a block covers its work."""
    if par.device.type == "cuda":
        torch.cuda.synchronize(par.device)


def _pir_setup(degree, plaintext_modulus, moduli_sizes, database_size,
               elements_size, seed, device):
    """The parameters, the client's rng, the database and its plaintext
    rows (database_rows) with their dimensions."""
    par = (BfvParametersBuilder().set_degree(degree)
           .set_plaintext_modulus(plaintext_modulus)
           .set_moduli_sizes(moduli_sizes).set_device(device).build())
    rng = ChaCha8Rng(seed_from_u64(seed))
    database = generate_database(database_size, elements_size)
    values, (dim1, dim2) = database_rows(database, par)
    return par, rng, database, values, dim1, dim2


def _default_plaintext(degree: int) -> int:
    return generate_prime(16, 2 * degree, 1 << 16)


def _client_query(par, sk, rng, index, dim1, dim2, elements_size):
    """The query for element `index` at level 1: (2^level)^-1 mod t on the
    two selectors of its plaintext's cell, and the expansion level."""
    t = par.plaintext.value
    plaintext_nbits = t.bit_length() - 1
    level = max((dim1 + dim2 - 1).bit_length(), 1)
    query_index = index // number_elements_per_plaintext(
        par.degree(), plaintext_nbits, elements_size)
    pt = np.zeros(dim1 + dim2, dtype=np.uint64)
    inv = inverse(1 << level, t)
    pt[query_index // dim2] = inv
    pt[dim1 + (query_index % dim2)] = inv
    query_pt = Plaintext.try_encode(pt, Encoding.poly(1), par)
    return sk.try_encrypt(query_pt, rng), level


def _element(par, values, index: int, elements_size: int) -> bytes:
    """Element `index` out of the decoded plaintext `values` of its row."""
    nbits = par.plaintext.value.bit_length() - 1
    plaintext_bytes = transcode_to_bytes(values, nbits)
    offset = index % number_elements_per_plaintext(par.degree(), nbits,
                                                   elements_size)
    return bytes(plaintext_bytes[offset * elements_size:
                                 (offset + 1) * elements_size])


def _stacked(cts: list) -> Ciphertext:
    """Ciphertexts of one level as one batched ciphertext."""
    return Ciphertext(cts[0].par, [torch.stack([c[i] for c in cts])
                                   for i in range(len(cts[0]))],
                      cts[0].level)


def _unstacked(ct: Ciphertext) -> list:
    """A (m, 1, k, N) batched ciphertext as m unbatched ones."""
    return [Ciphertext(ct.par, [x[j, 0] for x in ct.c], ct.level)
            for j in range(ct.c[0].shape[0])]


def run_mulpir(database_size=64, elements_size=16, degree=64,
               plaintext_modulus=None, moduli_sizes=(50, 55, 55), seed=17,
               report: dict | None = None, fused: bool | None = None,
               repeat: int = 1, device=None):
    """End-to-end MulPIR; returns (retrieved element, expected element).

    Defaults are test-sized; the paper configuration is degree=8192,
    t = PAPER_PLAINTEXT, moduli_sizes=(50, 55, 55), 65,536 elements of 1
    KiB (examples/mulpir.rs:163-208). `report={}` collects the phases'
    seconds (host clock, each block ending on a synchronize) and the wire
    sizes. fused: the programs (True) or the object API (False); None
    takes the programs on a CUDA device."""
    if plaintext_modulus is None:
        plaintext_modulus = _default_plaintext(degree)
    with timeit("mulpir/setup", report, "setup_s"):
        par, rng, database, values, dim1, dim2 = _pir_setup(
            degree, plaintext_modulus, moduli_sizes, database_size,
            elements_size, seed, device)
    if fused is None:
        fused = par.device.type == "cuda"
    if report is not None:
        report["dims"] = (dim1, dim2)

    with timeit("mulpir/keygen", report, "keygen_s"):
        sk = SecretKey.random(par, rng)
        level = max((dim1 + dim2 - 1).bit_length(), 1)
        ek_expansion = (EvaluationKeyBuilder(sk, ciphertext_level=1,
                                             evaluation_key_level=0)
                        .enable_expansion(level).build(rng))
        rk = RelinearizationKey.new(sk, rng, ciphertext_level=1, key_level=1)
        _sync(par)
    if report is not None:
        report["ek_bytes"] = len(ek_expansion.to_bytes())
        report["rk_bytes"] = len(rk.to_bytes())

    index = int(np.random.default_rng(seed).integers(0, database_size))
    with timeit("mulpir/query", report, "query_s"):
        query, level = _client_query(par, sk, rng, index, dim1, dim2,
                                     elements_size)
        _sync(par)
    if report is not None:
        report["query_bytes"] = len(query.to_bytes())

    # the encoded database is the server's state, uploaded once
    with timeit("mulpir/db_upload", report, "db_upload_s"):
        db_rows, preprocessed = encode_rows(values, par, 1)
        _sync(par)

    if fused:
        db = db_rows.reshape(dim1, dim2, *db_rows.shape[1:])
        expand_fn = make_expand(par, ek_expansion, level, level=1)
        resp_fn = make_pir_response_db(par, rk, dim1, dim2, level=1)

        def serve(q, suffix=""):
            with timeit("mulpir/expand" + suffix, report,
                        f"expand{suffix}_s"):
                e0, e1 = expand_fn(q[0][None], q[1][None])
                _sync(par)
            with timeit("mulpir/response" + suffix, report,
                        f"response{suffix}_s"):
                o0, o1 = resp_fn(e0, e1, db)
                res = Ciphertext(par, [o0[0], o1[0]], 1)
                res.switch_to_level(res.max_switchable_level())
                _sync(par)
            return res
    else:
        def serve(q, suffix=""):
            with timeit("mulpir/expand" + suffix, report,
                        f"expand{suffix}_s"):
                expanded = ek_expansion.expands(q, dim1 + dim2)
                _sync(par)
            with timeit("mulpir/response" + suffix, report,
                        f"response{suffix}_s"):
                query_vec = expanded[:dim1]
                res = Ciphertext.zero(par)
                for i, ci in enumerate(expanded[dim1:]):
                    dot = dot_product_scalar(query_vec, preprocessed[i::dim2])
                    prod = ct_mul(dot, ci)
                    res = prod if not res.c else ct_add(res, prod)
                rk.relinearizes(res)
                res.switch_to_level(res.max_switchable_level())
                _sync(par)
            return res

    out = serve(query)
    if report is not None:
        report["response_bytes"] = len(out.to_bytes())
    if repeat > 1:
        # a second query, for another element, served warm
        idx2 = (index + 1) % database_size
        q2, _ = _client_query(par, sk, rng, idx2, dim1, dim2, elements_size)
        out2 = serve(q2, suffix="_warm")
        got2 = _element(par, sk.try_decrypt(out2).try_decode(
            Encoding.poly(out2.level)), idx2, elements_size)
        if got2 != bytes(database[idx2]):
            raise RuntimeError(f"warm query retrieved the wrong element "
                               f"(index {idx2})")
        if report is not None:
            report["warm_index"] = idx2

    with timeit("mulpir/answer", report, "answer_s"):
        pt = sk.try_decrypt(out)
        answer = _element(par, pt.try_decode(Encoding.poly(out.level)), index,
                          elements_size)
    return answer, bytes(database[index])


def _fold_values(parts: np.ndarray, q0_bits: int, plaintext_nbits: int,
                 degree: int) -> np.ndarray:
    """SealPIR's fold (sealpir.rs:176-201): each of m one-limb ciphertexts,
    (m, 2, N) NTT-domain words, its two parts transcoded from q0_bits into
    plaintext_nbits-bit values and cut into plaintexts of N values, the
    last zero-padded: (m, nfold, N) uint64."""
    m = parts.shape[0]
    vals = transcode_bidirectional(parts.astype(np.uint64), q0_bits,
                                   plaintext_nbits).reshape(m, -1)
    nfold = -((-vals.shape[1]) // degree)
    out = np.zeros((m, nfold * degree), dtype=np.uint64)
    out[:, : vals.shape[1]] = vals
    return out.reshape(m, nfold, degree)


def run_sealpir(database_size=64, elements_size=16, degree=64,
                plaintext_modulus=None, moduli_sizes=(50, 55, 55), seed=23,
                report: dict | None = None, fused: bool | None = None,
                device=None):
    """End-to-end SealPIR with the ciphertext-as-plaintext fold; returns
    (retrieved element, expected element). The server's fused path is
    make_expand, then make_ct_pt_dot for both dimensions, each
    dimension's responses switched to the last level as one batch; the
    fold between them is a host transcode on either path."""
    if plaintext_modulus is None:
        plaintext_modulus = _default_plaintext(degree)
    with timeit("sealpir/setup", report, "setup_s"):
        par, rng, database, values, dim1, dim2 = _pir_setup(
            degree, plaintext_modulus, moduli_sizes, database_size,
            elements_size, seed, device)
    if fused is None:
        fused = par.device.type == "cuda"
    t = par.plaintext.value
    plaintext_nbits = t.bit_length() - 1
    q0_bits = par.moduli[0].bit_length()
    n = par.degree()
    if report is not None:
        report["dims"] = (dim1, dim2)

    with timeit("sealpir/keygen", report, "keygen_s"):
        sk = SecretKey.random(par, rng)
        level = max((dim1 + dim2 - 1).bit_length(), 1)
        ek_expansion = (EvaluationKeyBuilder(sk, ciphertext_level=1,
                                             evaluation_key_level=0)
                        .enable_expansion(level).build(rng))
        _sync(par)

    index = int(np.random.default_rng(seed).integers(0, database_size))
    with timeit("sealpir/query", report, "query_s"):
        query, level = _client_query(par, sk, rng, index, dim1, dim2,
                                     elements_size)
        _sync(par)

    with timeit("sealpir/db_upload", report, "db_upload_s"):
        db_rows, preprocessed = encode_rows(values, par, 1)
        _sync(par)

    if fused:
        db = db_rows.reshape(dim1, dim2, *db_rows.shape[1:])
        expand_fn = make_expand(par, ek_expansion, level, level=1)
        dot1_fn = make_ct_pt_dot(par, dim1, dim2, level=1)
        with timeit("sealpir/expand", report, "expand_s"):
            e0, e1 = expand_fn(query[0][None], query[1][None])
            _sync(par)
        with timeit("sealpir/dot1", report, "dot1_s"):
            first = Ciphertext(par, list(dot1_fn(e0, e1, db)), 1)
            first.switch_to_level(first.max_switchable_level())
            parts = torch.stack(first.c, dim=1)[:, :, 0, 0].cpu().numpy()
        with timeit("sealpir/fold", report, "fold_s"):
            folded = _fold_values(parts, q0_bits, plaintext_nbits, n)
        with timeit("sealpir/dot2", report, "dot2_s"):
            pts2 = encode_pir_database(par, folded, Encoding.poly(1))
            dot2_fn = make_ct_pt_dot(par, dim2, folded.shape[1], level=1)
            second = Ciphertext(par, list(dot2_fn(e0[dim1:dim1 + dim2],
                                                  e1[dim1:dim1 + dim2],
                                                  pts2)), 1)
            second.switch_to_level(second.max_switchable_level())
            responses = _unstacked(second)
            _sync(par)
    else:
        with timeit("sealpir/expand", report, "expand_s"):
            expanded = ek_expansion.expands(query, dim1 + dim2)
        with timeit("sealpir/dot1", report, "dot1_s"):
            query_vec = expanded[:dim1]
            dot_products = []
            for i in range(dim2):
                c = dot_product_scalar(query_vec, preprocessed[i::dim2])
                c.switch_to_level(c.max_switchable_level())
                dot_products.append(c)
            parts = torch.stack(_stacked(dot_products).c, dim=1)[:, :, 0]
            parts = parts.cpu().numpy()
        with timeit("sealpir/fold", report, "fold_s"):
            folded = _fold_values(parts, q0_bits, plaintext_nbits, n)
            folds = [PlaintextVec.try_encode(list(row.reshape(-1)),
                                             Encoding.poly(1), par)
                     for row in folded]
        with timeit("sealpir/dot2", report, "dot2_s"):
            responses = []
            for i in range(len(folds[0])):
                outi = dot_product_scalar(expanded[dim1:],
                                          [f[i] for f in folds])
                outi.switch_to_level(outi.max_switchable_level())
                responses.append(outi)
    if report is not None:
        report["query_bytes"] = len(query.to_bytes())
        report["response_bytes"] = sum(len(r.to_bytes()) for r in responses)

    # client: decrypt the outer responses, rebuild the inner ciphertext at
    # the last level, decrypt it
    with timeit("sealpir/answer", report, "answer_s"):
        decrypted = np.concatenate([
            sk.try_decrypt(r).try_decode(Encoding.poly(r.level))
            for r in responses])
        expect_n = -((-n * q0_bits) // plaintext_nbits)
        polys = [transcode_bidirectional(
            decrypted[i * expect_n:(i + 1) * expect_n], plaintext_nbits,
            q0_bits)[:n] for i in (0, 1)]
        ctx = par.context_at_level(par.max_level())
        ct = Ciphertext.new(
            [torch.from_numpy(p.astype(np.int64)[None]).to(ctx.device)
             for p in polys], par)
        pt = sk.try_decrypt(ct)
        answer = _element(par, pt.try_decode(Encoding.poly(ct.level)), index,
                          elements_size)
    return answer, bytes(database[index])


def main(argv=None) -> int:
    """The CLI of the reference's examples (examples/pir.rs:8-24; tpufhe's
    models/pir.py main): --database-size and --element-size with the
    paper-scale defaults, --scheme and --degree. At degree 8192 both
    schemes take the paper plaintext modulus: tpufhe passes it to MulPIR
    only, and its SealPIR default, the largest 16-bit prime = 1 mod 2N,
    does not exist at N = 8192."""
    import argparse
    import time

    from tpufhe_torch.utils.obs import human_bytes, init_logging

    init_logging("info")
    ap = argparse.ArgumentParser(
        prog="python -m tpufhe_torch.models.pir",
        description="Run a MulPIR or SealPIR retrieval end to end.")
    ap.add_argument("--database-size", type=int, default=65536,
                    help="The number of elements in the database")
    ap.add_argument("--element-size", type=int, default=1024,
                    help="The size of each database element (bytes)")
    ap.add_argument("--scheme", choices=("mulpir", "sealpir"),
                    default="mulpir")
    ap.add_argument("--degree", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    kwargs = {"report": {}, "device": args.device}
    if args.degree == 8192:
        kwargs["plaintext_modulus"] = PAPER_PLAINTEXT
    run = run_mulpir if args.scheme == "mulpir" else run_sealpir
    t0 = time.perf_counter()
    got, want = run(database_size=args.database_size,
                    elements_size=args.element_size, degree=args.degree,
                    **kwargs)
    dt = time.perf_counter() - t0
    ok = got == want
    device = args.device or torch.cuda.get_device_name(0)
    print(f"{args.scheme} db={args.database_size}x{args.element_size}B "
          f"degree={args.degree} on {device}: {'OK' if ok else 'FAILED'} in "
          f"{dt:.1f} s")
    for k, v in kwargs["report"].items():
        if k.endswith("_bytes"):
            v = human_bytes(v)
        elif isinstance(v, float):
            v = round(v, 3)
        print(f"  {k:14s} {v}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
