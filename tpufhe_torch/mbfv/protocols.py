"""Multiparty BFV protocol shares (fhe/src/mbfv/*.rs; tpufhe's
mbfv/protocols.py).

Every share type carries the party's contribution as polynomials
(``rq.Poly``, NTT domain, on the parameters' device); ``aggregate`` sums
shares (mbfv/aggregate.rs:4-48). Protocols:

- PublicKeyShare      (Protocol 1 EncKeyGen,  public_key_gen.rs:16-79)
- RelinKeyGenerator   (Protocol 2 RelinKeyGen, 2 rounds, relin_key_gen.rs)
- SecretKeySwitchShare(Protocol 3 KeySwitch,  secret_key_switch.rs:24-110)
- DecryptionShare     (KeySwitch to the zero key, secret_key_switch.rs:118-193)
- PublicKeySwitchShare(Protocol 4 PubKeySwitch, public_key_switch.rs:18-109)

The transforms run K1 (K9 when narrow) on the card, the collective
decryption's t/q scale K2; the products and sums are plain torch, as they
are XLA in tpufhe. The smudging noise is the parameters' CBD, as in
tpufhe (not the exponentially larger noise the protocols' proofs ask for).
"""

from __future__ import annotations

import numpy as np
import torch

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.bfv.keys.relinearization_key import RelinearizationKey
from tpufhe_torch.bfv.keys.secret_key import SecretKey, scaled_plaintext
from tpufhe_torch.errors import (
    ContextMismatch,
    DimensionMismatch,
    InvalidCiphertext,
    TooFewValues,
    UnexpectedError,
    UnsupportedOperation,
)
from tpufhe_torch.ops.rns import RnsContext
from tpufhe_torch.ops.rq import NTT, Poly, ntt_backward, shoup_of


def aggregate(shares: list):
    """Sum shares into the aggregate object (mbfv/aggregate.rs)."""
    shares = list(shares)
    if not shares:
        raise TooFewValues(0, 1)
    return shares[0]._aggregate(shares)


def _sum(polys: list) -> Poly:
    acc = polys[0]
    for p in polys[1:]:
        acc = acc + p
    return acc


def _secret(sk_share, ctx) -> Poly:
    """A party's secret in the NTT domain of ctx."""
    return Poly.from_i64_coeffs(sk_share.coeffs, ctx).into_ntt()


def _part(ct: Ciphertext, i: int) -> Poly:
    return Poly(ct.par.context_at_level(ct.level), NTT, ct[i])


class CommonRandomPoly:
    """A uniform common reference polynomial (mbfv/crp.rs)."""

    def __init__(self, poly: Poly):
        self.poly = poly

    @staticmethod
    def new(par, rng, level: int = 0) -> "CommonRandomPoly":
        ctx = par.context_at_level(level)
        return CommonRandomPoly(Poly.random(ctx, rng, NTT))

    @staticmethod
    def new_vec(par, rng) -> list:
        return [CommonRandomPoly.new(par, rng) for _ in range(len(par.moduli))]


class PublicKeyShare:
    """p0_i = -a*s_i + e_i (public_key_gen.rs:33-57)."""

    def __init__(self, par, crp: CommonRandomPoly, p0_share: Poly):
        self.par = par
        self.crp = crp
        self.p0_share = p0_share

    @staticmethod
    def new(sk_share, crp: CommonRandomPoly, rng) -> "PublicKeyShare":
        par = sk_share.par
        ctx = par.context_at_level(0)
        s = _secret(sk_share, ctx)
        e = Poly.small(ctx, par.variance, rng, NTT)
        p0 = ((-crp.poly) * s) + e
        return PublicKeyShare(par, crp, p0)

    def _aggregate(self, shares):
        from tpufhe_torch.bfv.keys.public_key import PublicKey

        p0 = _sum([sh.p0_share for sh in shares])
        par = shares[0].par
        ct = Ciphertext.new([p0.coeffs, shares[0].crp.poly.coeffs], par)
        return PublicKey(par, ct)


class SecretKeySwitchShare:
    """h_i = (s_in,i - s_out,i) * c1 + e (secret_key_switch.rs:39-88)."""

    def __init__(self, par, ct: Ciphertext, h_share: Poly):
        self.par = par
        self.ct = ct
        self.h_share = h_share

    @staticmethod
    def new(sk_input_share, sk_output_share, ct: Ciphertext, rng
            ) -> "SecretKeySwitchShare":
        if (sk_input_share.par != sk_output_share.par
                or sk_output_share.par != ct.par):
            raise ContextMismatch("Incompatible BFV parameters")
        if len(ct) != 2:
            raise InvalidCiphertext("M-BFV only supports ciphertexts of length 2")
        par = sk_input_share.par
        ctx = par.context_at_level(ct.level)
        s_in = _secret(sk_input_share, ctx)
        s_out = _secret(sk_output_share, ctx)
        e = Poly.small(ctx, par.variance, rng, NTT)
        h = ((s_in - s_out) * _part(ct, 1)) + e
        return SecretKeySwitchShare(par, ct, h)

    def _aggregate(self, shares):
        h = _sum([sh.h_share for sh in shares])
        ct = shares[0].ct
        c0 = _part(ct, 0) + h
        return Ciphertext.new([c0.coeffs, ct[1]], shares[0].par)


class DecryptionShare:
    """KeySwitch to the zero key (secret_key_switch.rs:118-193)."""

    def __init__(self, sks_share: SecretKeySwitchShare):
        self.sks_share = sks_share

    @staticmethod
    def new(sk_input_share, ct: Ciphertext, rng) -> "DecryptionShare":
        par = sk_input_share.par
        zero = SecretKey(np.zeros(par.degree(), dtype=np.int64), par)
        return DecryptionShare(
            SecretKeySwitchShare.new(sk_input_share, zero, ct, rng))

    def _aggregate(self, shares):
        ct = aggregate([s.sks_share for s in shares])
        par = ct.par
        # c1*s has already been folded into c0; only the t/q scale remains
        ctx = par.context_at_level(ct.level)
        scaler = par.context_level_at(ct.level).cipher_plain_context.scaler
        d = scaler.rns_scaler.scale(ntt_backward(ctx, ct[0]))
        return scaled_plaintext(par, d, ct.level)


class PublicKeySwitchShare:
    """h0_i = u_i*pk0 + s_i*c1 + e0, h1_i = u_i*pk1 + e1
    (public_key_switch.rs:33-87)."""

    def __init__(self, par, c0: Poly, h0_share: Poly, h1_share: Poly):
        self.par = par
        self.c0 = c0
        self.h0_share = h0_share
        self.h1_share = h1_share

    @staticmethod
    def new(sk_share, public_key, ct: Ciphertext, rng) -> "PublicKeySwitchShare":
        if sk_share.par != public_key.par or public_key.par != ct.par:
            raise ContextMismatch("Incompatible BFV parameters")
        par = sk_share.par
        pk_ct = public_key.c
        if pk_ct.level != ct.level:
            pk_ct = pk_ct.clone()
            while pk_ct.level != ct.level:
                pk_ct.switch_down()
        ctx = par.context_at_level(ct.level)
        s = _secret(sk_share, ctx)
        u = Poly.small(ctx, par.variance, rng, NTT)
        e0 = Poly.small(ctx, par.variance, rng, NTT)
        e1 = Poly.small(ctx, par.variance, rng, NTT)
        h0 = (_part(pk_ct, 0) * u) + (s * _part(ct, 1)) + e0
        h1 = (_part(pk_ct, 1) * u) + e1
        return PublicKeySwitchShare(par, _part(ct, 0), h0, h1)

    def _aggregate(self, shares):
        h0 = _sum([sh.h0_share for sh in shares])
        h1 = _sum([sh.h1_share for sh in shares])
        c0 = shares[0].c0 + h0
        return Ciphertext.new([c0.coeffs, h1.coeffs], shares[0].par)


def collective_relinearization_key(par, c0: torch.Tensor, c1: torch.Tensor
                                   ) -> RelinearizationKey:
    """The key of the aggregated rounds (relin_key_gen.rs:302-358) from its
    NTT-domain (k, k, N) rows: c0_i = h0_i + h1_i of round 2's sums, c1_i
    round 1's aggregated h1_i (not the CRP); their Shoup constants beside
    them, no seed, log_base 0, at level 0."""
    ctx = par.context_at_level(0)
    ksk = KeySwitchingKey(par, None, c0, shoup_of(c0, ctx.moduli), c1,
                          shoup_of(c1, ctx.moduli), 0, 0, log_base=0)
    return RelinearizationKey(ksk)


class RelinKeyShare:
    """Round shares of the 2-round RelinKeyGen (relin_key_gen.rs:19-358)."""

    def __init__(self, par, h0: list, h1: list, last_round=None,
                 round_tag="r1"):
        self.par = par
        self.h0 = h0
        self.h1 = h1
        self.last_round = last_round
        self.round_tag = round_tag

    def _aggregate(self, shares):
        h0 = [_sum(rows) for rows in zip(*[sh.h0 for sh in shares])]
        h1 = [_sum(rows) for rows in zip(*[sh.h1 for sh in shares])]
        if self.round_tag == "r1":
            return RelinKeyShare(shares[0].par, h0, h1, None, "r1_aggregated")
        r1 = shares[0].last_round
        if r1 is None:
            raise UnexpectedError(
                "Round-2 shares must carry the round-1 aggregation")
        return collective_relinearization_key(
            shares[0].par, torch.stack([(a + b).coeffs for a, b in zip(h0, h1)]),
            torch.stack([h.coeffs for h in r1.h1]))


class RelinKeyGenerator:
    """Per-party generator for the 2-round protocol (relin_key_gen.rs:66-112).
    u is sampled once, at construction, and reused across rounds."""

    def __init__(self, sk_share, crp: list, rng):
        par = sk_share.par
        ctx = par.context_at_level(0)
        if ctx.k == 1:
            raise UnsupportedOperation(
                "These parameters do not support key switching")
        if len(crp) != ctx.k:
            raise DimensionMismatch(
                "CRP vector size must equal the number of moduli")
        self.sk_share = sk_share
        self.crp = crp
        self.u = Poly.small(ctx, par.variance, rng, NTT)

    def round_1(self, rng) -> RelinKeyShare:
        """h0_i = -a_j*u + garner_j*s + e;  h1_i = a_j*s + e
        (relin_key_gen.rs:141-197)."""
        par = self.sk_share.par
        ctx = par.context_at_level(0)
        s = _secret(self.sk_share, ctx)
        rns = RnsContext(list(par.moduli[: len(self.crp)]))
        h0 = []
        for i, a in enumerate(self.crp):
            w_s = s.scalar_mul(rns.get_garner(i))
            e = Poly.small(ctx, par.variance, rng, NTT)
            h0.append(((-a.poly) * self.u) + w_s + e)
        h1 = []
        for a in self.crp:
            e = Poly.small(ctx, par.variance, rng, NTT)
            h1.append((a.poly * s) + e)
        return RelinKeyShare(par, h0, h1, None, "r1")

    def round_2(self, r1_aggregated: RelinKeyShare, rng) -> RelinKeyShare:
        """h0'_i = h0*s + e;  h1'_i = h1*(u - s) + e
        (relin_key_gen.rs:227-300)."""
        par = self.sk_share.par
        ctx = par.context_at_level(0)
        s = _secret(self.sk_share, ctx)
        u_s = self.u - s
        h0 = [(h * s) + Poly.small(ctx, par.variance, rng, NTT)
              for h in r1_aggregated.h0]
        h1 = [(h * u_s) + Poly.small(ctx, par.variance, rng, NTT)
              for h in r1_aggregated.h1]
        return RelinKeyShare(par, h0, h1, r1_aggregated, "r2")
