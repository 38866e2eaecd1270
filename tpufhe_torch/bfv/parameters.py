"""BFV parameters: modulus chain, per-level contexts, precomputed scalers.

The port of tpufhe/bfv/parameters.py (fhe/src/bfv/parameters.rs):
BfvParametersBuilder validates the degree and moduli, generates NTT-friendly primes
from sizes, builds the per-level contexts with delta = lift((-t)^{-1} mod q),
q mod t and the t/q decryption scaler, the extended multiplication basis
(62-bit primes, or 30-bit ones for a narrow set whose moduli are all below
2^30) with each level's extender and down-scaler, and the SEAL
batch-encoder permutation. Everything here is host-side precomputation
with exact Python ints; `device` says where the contexts keep their tables
and where every entry point built on these parameters runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpufhe_torch.device import resolve_device
from tpufhe_torch.errors import (
    FheError,
    InvalidContext,
    InvalidLevel,
    ParametersError,
)
from tpufhe_torch.ops.rns import ScalingFactor
from tpufhe_torch.ops.rq import Context, Scaler
from tpufhe_torch.ops.zq import Modulus
from tpufhe_torch.utils.primes import generate_prime

# variance of the centered-binomial error and key distributions
# (parameters.rs default)
VARIANCE = 10

# the ciphertext moduli of the default sets of about 128-bit security, by
# degree (parameters.rs:217-294)
DEFAULT_128_MODULI = {
    1024: [0x7E00001],
    2048: [0x3FFFFFFF000001],
    4096: [0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001],
    8192: [0x7FFFFFD8001, 0x7FFFFFC8001, 0xFFFFFFFC001, 0xFFFFFF6C001,
           0xFFFFFEBC001],
    16384: [0xFFFFFFFD8001, 0xFFFFFFFA0001, 0xFFFFFFF00001, 0x1FFFFFFF68001,
            0x1FFFFFFF50001, 0x1FFFFFFEE8001, 0x1FFFFFFEA0001,
            0x1FFFFFFE88001, 0x1FFFFFFE48001],
}


class PlaintextModulus:
    """The plaintext space; only small moduli (< 2^62) are ported."""

    def __init__(self, t: int):
        self.value = int(t)
        self.is_small = self.value < (1 << 62)
        if not self.is_small:
            raise ParametersError("plaintext moduli of 62 bits and more are "
                                  "not supported by tpufhe_torch yet")
        self.modulus = Modulus(self.value)

    def __eq__(self, other):
        return isinstance(other, PlaintextModulus) and self.value == other.value


class CipherPlainContext:
    """Bridge between a ciphertext context and the plaintext space
    (context/cipher_plain_context.rs:10-50)."""

    def __init__(self, plaintext_context, ciphertext_context, delta, q_mod_t,
                 plain_threshold, scaler):
        self.plaintext_context = plaintext_context
        self.ciphertext_context = ciphertext_context
        # lift((-t)^{-1} mod q) as (k, 1) residues: the NTT form of the
        # constant polynomial, equal in every slot
        self.delta = delta
        self.q_mod_t = q_mod_t
        self.plain_threshold = plain_threshold
        self.scaler = scaler  # Scaler cipher -> plaintext with factor t/q


class ContextLevel:
    """A node of the modulus chain (context/chain.rs:12-141)."""

    def __init__(self, poly_context: Context, cipher_plain_context, level: int):
        self.poly_context = poly_context
        self.cipher_plain_context = cipher_plain_context
        self.level = level
        self.num_moduli = poly_context.k
        self._mul_params = None
        self._mul_params_builder = None

    def mul_params(self) -> "MultiplicationParameters":
        if self._mul_params is None:
            self._mul_params = self._mul_params_builder()
        return self._mul_params


@dataclass
class MultiplicationParameters:
    """Extend / tensor / down-scale contexts of one level
    (parameters.rs:694-717)."""

    extender: Scaler
    down_scaler: Scaler
    from_ctx: Context
    to_ctx: Context


class BfvParameters:
    """Consolidated BFV parameters + precomputed per-level data."""

    def __init__(self, degree, moduli, moduli_sizes, variance, context_chain,
                 ntt_operator, plaintext, matrix_reps_index_map, device):
        self.polynomial_degree = degree
        self.moduli = tuple(moduli)
        self.moduli_sizes = tuple(moduli_sizes)
        self.variance = variance
        self.context_chain = context_chain  # list[ContextLevel], level 0 first
        self.ntt_operator = ntt_operator  # plaintext-space Context or None
        self.plaintext = plaintext
        self.matrix_reps_index_map = matrix_reps_index_map
        self.device = device

    def degree(self) -> int:
        return self.polynomial_degree

    def plaintext_value(self) -> int:
        return self.plaintext.value

    def max_level(self) -> int:
        return len(self.moduli) - 1

    def context_at_level(self, level: int) -> Context:
        return self.context_level_at(level).poly_context

    def context_level_at(self, level: int) -> ContextLevel:
        if not (0 <= level <= self.max_level()):
            raise InvalidLevel(level, 0, self.max_level())
        return self.context_chain[level]

    def level_of_context(self, ctx: Context) -> int:
        """The level whose ciphertext context is ctx."""
        for node in self.context_chain:
            if node.poly_context is ctx:
                return node.level
        raise InvalidContext("the context is not in the modulus chain")

    def __eq__(self, other):
        return (
            isinstance(other, BfvParameters)
            and self.polynomial_degree == other.polynomial_degree
            and self.moduli == other.moduli
            and self.plaintext == other.plaintext
            and self.variance == other.variance
            and self.device == other.device
        )

    @staticmethod
    def default_parameters_128(plaintext_nbits: int, device=None
                               ) -> list["BfvParameters"]:
        """The default sets of about 128-bit security, one per degree 1024
        to 16384 whose moduli hold the plaintext, with t the largest
        NTT-friendly prime of plaintext_nbits bits (parameters.rs:217-294,
        tpufhe parameters.py:135-186). The N = 1024 set's one 27-bit
        modulus makes it narrow (w30). A set that fails to build is left
        out, as in tpufhe."""
        if not 0 < plaintext_nbits < 64:
            raise ParametersError("plaintext_nbits must be in 1..=63")
        device = resolve_device(device)
        out = []
        for n, moduli in sorted(DEFAULT_128_MODULI.items()):
            t = generate_prime(plaintext_nbits, 2 * n,
                               ((1 << 64) - 1) >> (64 - plaintext_nbits))
            if (t is None
                    or sum(m.bit_length() for m in moduli) < plaintext_nbits):
                continue
            try:
                out.append(BfvParametersBuilder().set_degree(n)
                           .set_plaintext_modulus(t).set_moduli(moduli)
                           .set_device(device).build())
            except FheError:
                continue
        if not out:
            raise ParametersError(
                "No default parameters available for this plaintext size")
        return out

    @staticmethod
    def default(num_moduli: int, degree: int, device=None) -> "BfvParameters":
        """Test parameters (parameters.rs:300-311)."""
        return (
            BfvParametersBuilder()
            .set_degree(degree)
            .set_plaintext_modulus(1153)
            .set_moduli_sizes([62] * num_moduli)
            .set_device(device)
            .build()
        )


class BfvParametersBuilder:
    """Builder mirroring parameters.rs:313-641."""

    def __init__(self):
        self._degree = 0
        self._plaintext = 0
        self._moduli: list[int] = []
        self._moduli_sizes: list[int] = []
        self._device = None

    def set_degree(self, degree: int) -> "BfvParametersBuilder":
        self._degree = degree
        return self

    def set_plaintext_modulus(self, t: int) -> "BfvParametersBuilder":
        self._plaintext = int(t)
        return self

    def set_moduli(self, moduli) -> "BfvParametersBuilder":
        self._moduli = [int(m) for m in moduli]
        return self

    def set_moduli_sizes(self, sizes) -> "BfvParametersBuilder":
        self._moduli_sizes = list(sizes)
        return self

    def set_device(self, device) -> "BfvParametersBuilder":
        """Where the parameters' tables live and their entry points run:
        None (the default) is the CUDA card, "cpu" the CPU."""
        self._device = device
        return self

    @staticmethod
    def generate_moduli(sizes, degree) -> list[int]:
        """NTT-friendly distinct primes of the given sizes
        (parameters.rs:383-423)."""
        moduli = []
        for i, size in enumerate(sizes):
            if size > 62 or size < 10:
                raise ParametersError(f"modulus size at index {i} must be in 10..=62")
            upper_bound = 1 << size
            while True:
                prime = generate_prime(size, 2 * degree, upper_bound)
                if prime is None:
                    raise ParametersError(
                        f"not enough primes of size {size} for degree {degree}"
                    )
                if prime not in moduli:
                    moduli.append(prime)
                    break
                upper_bound = prime
        return moduli

    def build(self) -> BfvParameters:
        device = resolve_device(self._device)
        degree = self._degree
        if degree < 8 or (degree & (degree - 1)) != 0:
            raise ParametersError("invalid degree")

        plaintext = PlaintextModulus(self._plaintext)
        t = plaintext.value

        if self._moduli and self._moduli_sizes:
            raise ParametersError(
                "Only one of `moduli` and `moduli_sizes` can be specified"
            )
        if not self._moduli and not self._moduli_sizes:
            raise ParametersError("moduli or moduli_sizes must be specified")
        moduli = (
            self.generate_moduli(self._moduli_sizes, degree)
            if self._moduli_sizes
            else list(self._moduli)
        )
        moduli_sizes = [m.bit_length() for m in moduli]
        # sets with every modulus below 2^30 use the narrow (w30) mode end
        # to end: int32 rows, kernel K9 and ops/zq32.py; the SIMD context
        # over t stays wide, as in tpufhe
        narrow = all(m < (1 << 30) for m in moduli)

        # plaintext context: enough moduli so product > t by >= 60 bits
        t_bits = t.bit_length()
        acc, count = 0, 0
        for size in moduli_sizes:
            acc += size
            count += 1
            if acc >= t_bits + 60:
                break
        count = min(max(count, 1), len(moduli))
        plaintext_context = Context(tuple(moduli[:count]), degree, device,
                                    narrow)

        # plaintext-space NTT for SIMD (None when t does not support it)
        try:
            ntt_operator = Context((t,), degree, device)
        except ValueError:
            ntt_operator = None

        nodes = []
        for lvl in range(len(moduli)):
            level_moduli = tuple(moduli[: len(moduli) - lvl])
            cipher_ctx = Context(level_moduli, degree, device, narrow)
            delta_rests = []
            for m in level_moduli:
                q = Modulus(m)
                inv = q.inv(q.neg(t % m))
                if inv is None:
                    raise ParametersError("Inverse failed")
                delta_rests.append(inv)
            rns = cipher_ctx.rns
            delta_int = rns.lift(delta_rests)
            delta = torch.tensor([delta_int % m for m in level_moduli],
                                 dtype=cipher_ctx.dtype, device=device)[:, None]
            scaler = Scaler(cipher_ctx, plaintext_context,
                            ScalingFactor(t, rns.product))
            cp = CipherPlainContext(plaintext_context, cipher_ctx, delta,
                                    rns.product % t, (t + 1) >> 1, scaler)
            nodes.append(ContextLevel(cipher_ctx, cp, lvl))

        # extended basis for multiplication (parameters.rs:586-593); its
        # primes match the mode (62-bit, or 30-bit and more of them when
        # narrow), so the multiplication context stays in the same
        # representation
        ext_size = 30 if narrow else 62
        extended_basis: list[int] = []
        upper_bound = 1 << ext_size
        n_ext_target = (-((-(sum(moduli_sizes) + 60)) // ext_size) + 1
                        if narrow else len(moduli) + 1)
        while len(extended_basis) != n_ext_target:
            upper_bound = generate_prime(ext_size, 2 * degree, upper_bound)
            if upper_bound not in extended_basis and upper_bound not in moduli:
                extended_basis.append(upper_bound)

        # per-level multiplication parameters, built lazily
        for i, node in enumerate(nodes):
            def build_mp(i=i, node=node):
                modulus_size = sum(moduli_sizes[: len(moduli_sizes) - i])
                n_extra = -((-(modulus_size + 60)) // ext_size)
                mul_moduli = tuple(
                    moduli[: len(moduli_sizes) - i] + extended_basis[:n_extra]
                )
                mul_ctx = Context(mul_moduli, degree, device, narrow)
                return MultiplicationParameters(
                    extender=Scaler(node.poly_context, mul_ctx,
                                    ScalingFactor.one()),
                    down_scaler=Scaler(
                        mul_ctx, node.poly_context,
                        ScalingFactor(t, node.poly_context.modulus())),
                    from_ctx=node.poly_context,
                    to_ctx=mul_ctx,
                )

            node._mul_params_builder = build_mp

        # SEAL batch-encoder permutation (parameters.rs:614-629)
        row_size = degree >> 1
        m2 = degree << 1
        pos = 1
        logn = degree.bit_length() - 1
        matrix_reps_index_map = np.zeros(degree, dtype=np.int64)
        for i in range(row_size):
            index1 = (pos - 1) >> 1
            index2 = (m2 - pos - 1) >> 1
            matrix_reps_index_map[i] = int(f"{index1:0{logn}b}"[::-1], 2)
            matrix_reps_index_map[row_size | i] = int(f"{index2:0{logn}b}"[::-1], 2)
            pos = (pos * 3) & (m2 - 1)

        return BfvParameters(
            degree=degree,
            moduli=moduli,
            moduli_sizes=moduli_sizes,
            variance=VARIANCE,
            context_chain=nodes,
            ntt_operator=ntt_operator,
            plaintext=plaintext,
            matrix_reps_index_map=matrix_reps_index_map,
            device=device,
        )
