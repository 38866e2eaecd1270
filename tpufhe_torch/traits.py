"""API contracts mirroring the reference's fhe-traits crate
(fhe-traits/src/lib.rs:11-171): the port's own copy of tpufhe/traits.py.

These abstract base classes define the capability surface every scheme
implementation exposes: parametrized objects, plaintext encoders/decoders,
encrypters/decrypters, and the three deserialization flavors (plain,
parametrized, with-context). The concrete tpufhe_torch.bfv classes are
registered as virtual subclasses at the bottom of this module, so
isinstance checks against these ABCs work for generic user code, and each
registered class carries the corresponding trait methods (to_bytes /
from_bytes / try_encrypt / try_decrypt / ...).
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class FheParameters(ABC):
    """Marker for scheme parameter objects."""


class FheParametrized(ABC):
    """An object tied to a parameter set (exposes `.par`)."""


class FhePlaintextEncoding(ABC):
    """Marker for plaintext encodings."""


class FhePlaintext(FheParametrized):
    """A plaintext with an associated encoding type."""


class FheCiphertext(FheParametrized):
    """A ciphertext (serializable, parametrized)."""


class FheEncoder(ABC):
    """Encode a value into a plaintext."""

    @staticmethod
    @abstractmethod
    def try_encode(value, encoding, par):
        ...


class FheDecoder(ABC):
    """Decode a plaintext into a value."""

    @abstractmethod
    def try_decode(self, encoding=None):
        ...


class FheEncrypter(ABC):
    """Encrypt a plaintext into a ciphertext; RNG passed explicitly."""

    @abstractmethod
    def try_encrypt(self, pt, rng):
        ...


class FheDecrypter(ABC):
    """Decrypt a ciphertext into a plaintext."""

    @abstractmethod
    def try_decrypt(self, ct):
        ...


class Serialize(ABC):
    """Byte-level serialization (wire-compatible with the reference)."""

    @abstractmethod
    def to_bytes(self) -> bytes:
        ...


class Deserialize(ABC):
    @staticmethod
    @abstractmethod
    def try_deserialize(data: bytes):
        ...


class DeserializeParametrized(ABC):
    """Deserialization that needs the parameter set."""

    @staticmethod
    @abstractmethod
    def from_bytes(data: bytes, par):
        ...


class DeserializeWithContext(ABC):
    """Deserialization that needs a polynomial context."""

    @staticmethod
    @abstractmethod
    def from_bytes(data: bytes, ctx):
        ...


class FheParametersSwitchable(ABC):
    """Parameter/modulus switching hook (fhe-traits/src/lib.rs:20-30)."""

    @abstractmethod
    def switch_parameters(self, other):
        ...


def _register_implementations():
    """Register the concrete BFV classes as virtual subclasses.

    The mapping mirrors the reference's trait impls: Ciphertext/keys
    implement Serialize + DeserializeParametrized
    (e.g. fhe/src/bfv/ciphertext.rs impl blocks), SecretKey implements
    FheEncrypter + FheDecrypter (secret_key.rs:186-282), PublicKey
    implements FheEncrypter (public_key.rs:49-87), Plaintext implements
    FheEncoder/FheDecoder (plaintext_vec.rs:19-234, plaintext.rs:270-447).
    """
    from tpufhe_torch.bfv.ciphertext import Ciphertext
    from tpufhe_torch.bfv.keys.evaluation_key import EvaluationKey
    from tpufhe_torch.bfv.keys.galois_key import GaloisKey
    from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
    from tpufhe_torch.bfv.keys.public_key import PublicKey
    from tpufhe_torch.bfv.keys.relinearization_key import RelinearizationKey
    from tpufhe_torch.bfv.keys.secret_key import SecretKey
    from tpufhe_torch.bfv.parameters import BfvParameters
    from tpufhe_torch.bfv.plaintext import Plaintext, PlaintextVec
    from tpufhe_torch.bfv.encoding import Encoding
    from tpufhe_torch.bfv.rgsw import RGSWCiphertext
    from tpufhe_torch.ops.rq import Poly

    FheParameters.register(BfvParameters)
    Serialize.register(BfvParameters)
    Deserialize.register(BfvParameters)
    FhePlaintextEncoding.register(Encoding)
    FhePlaintext.register(Plaintext)
    FheEncoder.register(Plaintext)
    FheEncoder.register(PlaintextVec)
    FheDecoder.register(Plaintext)
    FheCiphertext.register(Ciphertext)
    FheEncrypter.register(SecretKey)
    FheDecrypter.register(SecretKey)
    FheEncrypter.register(PublicKey)
    DeserializeWithContext.register(Poly)
    for cls in (
        Ciphertext,
        PublicKey,
        SecretKey,
        KeySwitchingKey,
        RelinearizationKey,
        GaloisKey,
        EvaluationKey,
        RGSWCiphertext,
        Poly,
    ):
        FheParametrized.register(cls)
        Serialize.register(cls)
        if cls is not Poly:
            DeserializeParametrized.register(cls)


_register_implementations()
