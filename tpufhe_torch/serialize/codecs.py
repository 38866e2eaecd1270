"""Serializers and deserializers of every BFV object, byte for byte those
of tpufhe/serialize/codecs.py (fhe-math/src/proto/rq.proto,
fhe/src/proto/bfv.proto).

- An Rq message carries the power-basis coefficients of its polynomial,
  each residue in bitlen(p - 1) bits (zq/mod.rs:773-793,
  rq/convert.rs:17-42), beside its representation's tag; the decoder
  returns it to the tagged representation (K1 on the card).
- A ciphertext stores every part but the last, then the last part or
  the 32-byte seed that regenerates it (ciphertext.rs:167-241).
- A key-switching key stores c0 and either c1 or the seed of its chain
  (key_switching_key.rs:332-420); its polynomials carry the NTT_SHOUP tag
  and their Shoup constants are recomputed on load.

The port keeps an object's polynomials in one tensor, so the codecs move
them in bulk: every polynomial of an object leaves the NTT domain in one
K1 launch and reaches the host in one copy; a decoder builds them on its
parameters' device with one upload and one K1 launch. Only unbatched
objects serialize, as in tpufhe.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.evaluation_key import EvaluationKey, monomials
from tpufhe_torch.bfv.keys.galois_key import GaloisKey
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.bfv.keys.public_key import PublicKey
from tpufhe_torch.bfv.keys.relinearization_key import RelinearizationKey
from tpufhe_torch.bfv.keys.secret_key import SecretKey
from tpufhe_torch.bfv.parameters import BfvParameters, BfvParametersBuilder
from tpufhe_torch.bfv.rgsw import RGSWCiphertext
from tpufhe_torch.errors import SerializationError
from tpufhe_torch.ops.rq import (
    NTT,
    NTT_SHOUP,
    POWER_BASIS,
    Context,
    Poly,
    SubstitutionExponent,
    ntt_backward,
    ntt_forward,
    random_from_seed,
    shoup_of,
)
from tpufhe_torch.serialize.proto import (
    ProtoReader,
    emit_bytes_field,
    emit_packed_sint64,
    emit_packed_varints,
    emit_varint_field,
    encode_varint,
    parse_packed_varints,
    tag,
    zigzag_decode,
)

_REPR_TO_PROTO = {POWER_BASIS: 1, NTT: 2, NTT_SHOUP: 3}
_PROTO_TO_REPR = {v: k for k, v in _REPR_TO_PROTO.items()}


# ---------------------------------------------------------------------------
# Rq (polynomials)
# ---------------------------------------------------------------------------


def _unbatched(x: torch.Tensor, rows: int) -> None:
    if x.dim() != rows:
        raise SerializationError(
            f"only unbatched objects serialize: parts {tuple(x.shape)}")


def encode_polys(ctx: Context, coeffs: torch.Tensor, representation: str
                 ) -> list:
    """Rq messages of the (m, k, N) rows `coeffs` of ctx, each tagged
    `representation`; NTT-domain rows (NTT, NTT_SHOUP) leave the NTT
    domain first, all m in one launch."""
    _unbatched(coeffs, 3)
    pb = coeffs if representation == POWER_BASIS else ntt_backward(ctx, coeffs)
    mat = pb.cpu().numpy()
    payload = np.concatenate(
        [q.serialize_vec(mat[:, i, :].astype(np.uint64))
         for i, q in enumerate(ctx.q)], axis=-1)
    head = (emit_varint_field(1, _REPR_TO_PROTO[representation])
            + emit_varint_field(2, ctx.degree))
    return [head + emit_bytes_field(3, row.tobytes()) for row in payload]


def _parse_poly(data: bytes, ctx: Context, expected: str | None):
    """(representation, payload) of one Rq message, with tpufhe's checks
    in tpufhe's order (codecs.py:64-84)."""
    representation = degree = 0
    payload = b""
    for field, _, v in ProtoReader(data):
        if field == 1:
            representation = v
        elif field == 2:
            degree = v
        elif field == 3:
            payload = v
    if representation not in _PROTO_TO_REPR:
        raise SerializationError("Invalid representation")
    rep = _PROTO_TO_REPR[representation]
    if degree % 8 != 0 or degree < 8 or degree != ctx.degree:
        raise SerializationError("Invalid degree")
    if len(payload) != sum(q.serialization_length(degree) for q in ctx.q):
        raise SerializationError("Invalid coefficients")
    if expected is not None and rep != expected:
        raise SerializationError("Representation mismatch")
    return rep, payload


def decode_polys(datas: list, ctx: Context, expected: str) -> torch.Tensor:
    """The (m, k, N) coefficients of m Rq messages of ctx, all tagged
    `expected`, in that representation on ctx's device (the Shoup
    constants of NTT_SHOUP are the caller's)."""
    payloads = [_parse_poly(d, ctx, expected)[1] for d in datas]
    buf = np.frombuffer(b"".join(payloads), np.uint8).reshape(len(datas), -1)
    rows, idx = [], 0
    for q in ctx.q:
        ln = q.serialization_length(ctx.degree)
        row = q.deserialize_vec(buf[:, idx:idx + ln])[:, :ctx.degree]
        if (row >= np.uint64(q.p)).any():
            raise SerializationError("Coefficient out of range")
        rows.append(row)
        idx += ln
    mat = np.stack(rows, axis=1)
    words = mat.astype(np.int32 if ctx.narrow else np.int64, order="C")
    x = torch.from_numpy(words).to(ctx.device)
    return x if expected == POWER_BASIS else ntt_forward(ctx, x)


def serialize_poly(p: Poly) -> bytes:
    p._not_lazy("serialization")  # tpufhe codecs.py:48 asserts it
    return encode_polys(p.ctx, p.coeffs[None] if p.coeffs.dim() == 2
                        else p.coeffs, p.representation)[0]


def deserialize_poly(data: bytes, ctx: Context,
                     expected_representation: str | None = None) -> Poly:
    rep, _ = _parse_poly(data, ctx, expected_representation)
    p = Poly(ctx, rep, decode_polys([data], ctx, rep)[0])
    return p.compute_shoup() if rep == NTT_SHOUP else p


# ---------------------------------------------------------------------------
# Ciphertext
# ---------------------------------------------------------------------------


def serialize_ciphertext(ct: Ciphertext) -> bytes:
    out = b""
    if ct.c:
        ctx = ct.par.context_at_level(ct.level)
        parts = ct.c[:-1] if ct.seed is not None else ct.c
        for msg in encode_polys(ctx, torch.stack(parts), NTT):
            out += emit_bytes_field(1, msg, always=True)
        if ct.seed is not None:
            out += emit_bytes_field(2, ct.seed)
    out += emit_varint_field(3, ct.level)
    return out


def deserialize_ciphertext(data: bytes, par: BfvParameters) -> Ciphertext:
    c_bytes = []
    seed = b""
    level = 0
    for field, _, v in ProtoReader(data):
        if field == 1:
            c_bytes.append(v)
        elif field == 2:
            seed = v
        elif field == 3:
            level = v
    if not c_bytes or (len(c_bytes) == 1 and not seed):
        raise SerializationError("Not enough polynomials")
    if level > par.max_level():
        raise SerializationError("Invalid level")
    ctx = par.context_at_level(level)
    c = list(decode_polys(c_bytes, ctx, NTT))
    seed_out = None
    if seed:
        if len(seed) != 32:
            raise SerializationError("Invalid seed size")
        seed_out = bytes(seed)
        c.append(random_from_seed(ctx, seed_out))
    return Ciphertext(par, c, level, seed=seed_out)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def serialize_ksk(ksk: KeySwitchingKey) -> bytes:
    rows = ksk.c0.shape[0]
    polys = ksk.c0 if ksk.seed is not None else torch.cat([ksk.c0, ksk.c1])
    msgs = encode_polys(ksk.ctx_ksk, polys, NTT_SHOUP)
    out = b"".join(emit_bytes_field(1, m, always=True) for m in msgs[:rows])
    if ksk.seed is None:
        out += b"".join(emit_bytes_field(2, m, always=True)
                        for m in msgs[rows:])
    else:
        out += emit_bytes_field(3, ksk.seed)
    out += emit_varint_field(4, ksk.ciphertext_level)
    out += emit_varint_field(5, ksk.ksk_level)
    out += emit_varint_field(6, ksk.log_base)
    return out


def deserialize_ksk(data: bytes, par: BfvParameters) -> KeySwitchingKey:
    c0_bytes, c1_bytes = [], []
    seed = b""
    ciphertext_level = ksk_level = log_base = 0
    for field, _, v in ProtoReader(data):
        if field == 1:
            c0_bytes.append(v)
        elif field == 2:
            c1_bytes.append(v)
        elif field == 3:
            seed = v
        elif field == 4:
            ciphertext_level = v
        elif field == 5:
            ksk_level = v
        elif field == 6:
            log_base = v
    ctx_ksk = par.context_at_level(ksk_level)
    par.context_at_level(ciphertext_level)  # InvalidLevel, as tpufhe
    if not c0_bytes:
        raise SerializationError("Invalid c0/c1 sizes")
    c0 = decode_polys(c0_bytes, ctx_ksk, NTT_SHOUP)
    seed_out = None
    if seed:
        if len(seed) != 32:
            raise SerializationError("Invalid seed size")
        seed_out = bytes(seed)
        c1 = KeySwitchingKey._generate_c1(ctx_ksk, seed_out, c0.shape[0])
    else:
        c1 = decode_polys(c1_bytes, ctx_ksk, NTT_SHOUP) if c1_bytes else None
        if c1 is None or c1.shape[0] != c0.shape[0]:
            raise SerializationError("Invalid c0/c1 sizes")
    return KeySwitchingKey(par, seed_out, c0, shoup_of(c0, ctx_ksk.moduli),
                           c1, shoup_of(c1, ctx_ksk.moduli), ciphertext_level,
                           ksk_level, log_base)


def serialize_relinearization_key(rk: RelinearizationKey) -> bytes:
    return emit_bytes_field(1, serialize_ksk(rk.ksk), always=True)


def deserialize_relinearization_key(data: bytes, par) -> RelinearizationKey:
    for field, _, v in ProtoReader(data):
        if field == 1:
            return RelinearizationKey(deserialize_ksk(v, par))
    raise SerializationError("Invalid serialization")


def serialize_galois_key(gk: GaloisKey) -> bytes:
    out = emit_bytes_field(1, serialize_ksk(gk.ksk), always=True)
    out += emit_varint_field(2, gk.element.exponent)
    return out


def deserialize_galois_key(data: bytes, par) -> GaloisKey:
    ksk = None
    exponent = 0
    for field, _, v in ProtoReader(data):
        if field == 1:
            ksk = deserialize_ksk(v, par)
        elif field == 2:
            exponent = v
    if ksk is None:
        raise SerializationError("Invalid serialization")
    return GaloisKey(SubstitutionExponent(ksk.ctx_ciphertext, exponent), ksk)


def serialize_evaluation_key(ek: EvaluationKey) -> bytes:
    out = b""
    for gk in ek.gk.values():
        out += emit_bytes_field(2, serialize_galois_key(gk), always=True)
    out += emit_varint_field(3, ek.ciphertext_level)
    out += emit_varint_field(4, ek.evaluation_key_level)
    return out


def deserialize_evaluation_key(data: bytes, par) -> EvaluationKey:
    gks = []
    ciphertext_level = evaluation_key_level = 0
    for field, _, v in ProtoReader(data):
        if field == 2:
            gks.append(deserialize_galois_key(v, par))
        elif field == 3:
            ciphertext_level = v
        elif field == 4:
            evaluation_key_level = v
    gk = {}
    for k in gks:
        if k.ksk.ciphertext_level != ciphertext_level:
            raise SerializationError(
                "Galois key has incorrect ciphertext level")
        if k.ksk.ksk_level != evaluation_key_level:
            raise SerializationError(
                "Galois key has incorrect evaluation key level")
        gk[k.element.exponent] = k
    return EvaluationKey(
        par, ciphertext_level, evaluation_key_level, gk,
        EvaluationKey.construct_rot_to_gk_exponent(par),
        monomials(par.context_at_level(ciphertext_level)))


def serialize_public_key(pk: PublicKey) -> bytes:
    return emit_bytes_field(1, serialize_ciphertext(pk.c), always=True)


def deserialize_public_key(data: bytes, par) -> PublicKey:
    for field, _, v in ProtoReader(data):
        if field == 1:
            c = deserialize_ciphertext(v, par)
            if c.level != 0:
                raise SerializationError("ciphertext level must be 0")
            return PublicKey(par, c)
    raise SerializationError("Missing field c")


def serialize_secret_key(sk: SecretKey) -> bytes:
    return emit_packed_sint64(1, [int(c) for c in sk.coeffs])


def deserialize_secret_key(data: bytes, par) -> SecretKey:
    coeffs = []
    for field, wire, v in ProtoReader(data):
        if field == 1:
            if wire == 2:
                coeffs.extend(zigzag_decode(x)
                              for x in parse_packed_varints(v))
            else:
                coeffs.append(zigzag_decode(v))
    if len(coeffs) != par.degree():
        raise SerializationError("SecretKey length mismatch")
    return SecretKey(np.array(coeffs, dtype=np.int64), par)


def serialize_rgsw(ct: RGSWCiphertext) -> bytes:
    out = emit_bytes_field(1, serialize_ksk(ct.ksk0), always=True)
    out += emit_bytes_field(2, serialize_ksk(ct.ksk1), always=True)
    return out


def deserialize_rgsw(data: bytes, par) -> RGSWCiphertext:
    ksk0 = ksk1 = None
    for field, _, v in ProtoReader(data):
        if field == 1:
            ksk0 = deserialize_ksk(v, par)
        elif field == 2:
            ksk1 = deserialize_ksk(v, par)
    if ksk0 is None or ksk1 is None:
        raise SerializationError("Missing ksk")
    if (ksk0.ksk_level != ksk0.ciphertext_level
            or ksk0.ciphertext_level != ksk1.ciphertext_level
            or ksk1.ciphertext_level != ksk1.ksk_level):
        raise SerializationError("Inconsistent key switching levels")
    return RGSWCiphertext(ksk0, ksk1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def serialize_parameters(par: BfvParameters) -> bytes:
    # prost's field order: the regular fields by number, then the oneof
    # (1, 2, 4, then 3 or 5); the oneof is emitted even when zero
    out = emit_varint_field(1, par.polynomial_degree)
    out += emit_packed_varints(2, par.moduli)
    out += emit_varint_field(4, par.variance)
    t = par.plaintext.value
    if par.plaintext.is_small:
        out += tag(3, 0) + encode_varint(t)
    else:
        nbytes = (t.bit_length() + 7) // 8
        out += emit_bytes_field(5, t.to_bytes(nbytes, "little"), always=True)
    return out


def deserialize_parameters(data: bytes, device=None) -> BfvParameters:
    degree = variance = 0
    moduli = []
    t = None
    for field, wire, v in ProtoReader(data):
        if field == 1:
            degree = v
        elif field == 2:
            if wire == 2:
                moduli.extend(parse_packed_varints(v))
            else:
                moduli.append(v)
        elif field == 3:
            t = v
        elif field == 5:
            t = int.from_bytes(v, "little")
        elif field == 4:
            variance = v
    if t is None:
        raise SerializationError("Missing plaintext modulus")
    return (BfvParametersBuilder().set_degree(degree).set_plaintext_modulus(t)
            .set_moduli(moduli).set_variance(variance).set_device(device)
            .build())
