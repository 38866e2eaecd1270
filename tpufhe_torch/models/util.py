"""PIR database helpers (examples/util.rs:72-135; tpufhe's models/util.py).

The database is one (elements, element_size) uint8 array, and its
plaintext rows are cut from it with one vectorized transcode and encoded
in one batched call (pipeline.encode_pir_database: one upload and one K1
launch), where tpufhe goes element by element and plaintext by plaintext.
The plaintexts are tpufhe's: the same values, encoding and level.
"""

from __future__ import annotations

import math

import numpy as np

from tpufhe_torch.bfv import (
    BfvParameters,
    BfvParametersBuilder,
    Encoding,
    Plaintext,
)
from tpufhe_torch.pipeline import encode_pir_database
from tpufhe_torch.utils.transcode import transcode_from_bytes


def default_parameters(num_moduli: int, degree: int, device=None,
                       plaintext_modulus: int | None = None) -> BfvParameters:
    """The walkthroughs' parameters: BfvParameters.default (t = 1153, 62-bit
    moduli), or the same moduli sizes with another plaintext modulus. The
    SIMD encoding needs 2N | t - 1, so t = 1153 (1152 = 2^7 9) serves
    degrees up to 64 only."""
    if plaintext_modulus is None:
        return BfvParameters.default(num_moduli, degree, device)
    return (BfvParametersBuilder().set_degree(degree)
            .set_plaintext_modulus(plaintext_modulus)
            .set_moduli_sizes([62] * num_moduli).set_device(device).build())


def generate_database(database_size: int, elements_size: int) -> np.ndarray:
    """(database_size, elements_size) uint8: element i is i as 4 bytes
    little-endian, then zeros."""
    assert database_size > 0 and elements_size > 0
    db = np.zeros((database_size, elements_size), dtype=np.uint8)
    head = np.arange(database_size, dtype="<u4").view(np.uint8)
    width = min(4, elements_size)
    db[:, :width] = head.reshape(database_size, 4)[:, :width]
    return db


def number_elements_per_plaintext(degree: int, plaintext_nbits: int,
                                  elements_size: int) -> int:
    return (plaintext_nbits * degree) // (elements_size * 8)


def database_rows(database, par: BfvParameters) -> tuple:
    """The plaintext rows of the database, (dim1 dim2, N) uint64 values
    below 2^nbits (nbits = bitlen(t) - 1), rows past the data zero, and
    the dimensions (dim1, dim2) of the square-ish layout."""
    db = np.asarray(database, dtype=np.uint8)
    assert db.ndim == 2 and db.shape[0] > 0
    count, elements_size = db.shape
    nbits = par.plaintext.value.bit_length() - 1
    nept = number_elements_per_plaintext(par.degree(), nbits, elements_size)
    number_rows = -((-count) // nept)
    dim1 = math.ceil(math.sqrt(number_rows))
    dim2 = -((-number_rows) // dim1)
    buf = np.zeros(number_rows * nept * elements_size, dtype=np.uint8)
    buf[: db.size] = db.reshape(-1)
    rows = transcode_from_bytes(buf.reshape(number_rows, -1), nbits)
    values = np.zeros((dim1 * dim2, par.degree()), dtype=np.uint64)
    values[:number_rows, : rows.shape[1]] = rows
    return values, (dim1, dim2)


def encode_rows(values: np.ndarray, par: BfvParameters, level: int) -> tuple:
    """Rows of plaintext values -> (their NTT residues at `level`, (rows, k,
    N) on par's device, and the Plaintexts in Encoding.poly(level) whose
    poly_ntt are those rows)."""
    encoding = Encoding.poly(level)
    db = encode_pir_database(par, values, encoding)
    pts = [Plaintext(par, values[i], encoding, level, db[i])
           for i in range(values.shape[0])]
    return db, pts


def encode_database(database, par: BfvParameters, level: int) -> tuple:
    """Reshape and encode the database as plaintext polynomials: (the
    Plaintexts, (dim1, dim2)), as tpufhe's encode_database."""
    values, dims = database_rows(database, par)
    return encode_rows(values, par, level)[1], dims
