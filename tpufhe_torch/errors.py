"""Typed exceptions: the port's copy of tpufhe/errors.py
(fhe/src/errors.rs:15-130, fhe-math/src/errors.rs:11-40), the same names,
bases and messages. Every error subclasses ValueError, as in tpufhe."""

from __future__ import annotations


class FheError(ValueError):
    """Base class for all tpufhe_torch errors (fhe/src/errors.rs:15)."""


class MathError(FheError):
    """Errors from the math layer (fhe-math/src/errors.rs:11-40)."""


class InvalidModulus(MathError):
    def __init__(self, modulus: int):
        super().__init__(
            f"Invalid modulus: modulus {modulus} should be between 2 and "
            f"(1 << 62) - 1."
        )
        self.modulus = modulus


class InvalidContext(MathError):
    def __init__(self, msg: str = "Invalid context provided."):
        super().__init__(msg)


class NoMoreContext(MathError):
    def __init__(self):
        super().__init__("This is the last context.")


class IncorrectRepresentation(MathError):
    def __init__(self, got, expected):
        super().__init__(
            f"Incorrect representation: got {got!r}, expected {expected!r}."
        )
        self.got, self.expected = got, expected


class InvalidSeedSize(MathError):
    def __init__(self, got: int, expected: int):
        super().__init__(
            f"Invalid seed: got {got} bytes, expected {expected} bytes."
        )


class ContextMismatch(FheError):
    def __init__(self, reason: str = "Context mismatch"):
        super().__init__(reason)


class EncodingMismatch(FheError):
    def __init__(self, found, expected):
        super().__init__(
            f"Encoding mismatch: found {found}, expected {expected}"
        )


class EncodingNotSupported(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Encoding not supported: {reason}")


class DataExceedsModulus(FheError):
    def __init__(self, value: int, modulus: int):
        super().__init__(f"Data value {value} exceeds modulus {modulus}")


class TooManyValues(FheError):
    def __init__(self, actual: int, limit: int):
        super().__init__(
            f"Too many values provided: {actual} exceeds limit {limit}"
        )


class TooFewValues(FheError):
    def __init__(self, actual: int, minimum: int):
        super().__init__(
            f"Too few values provided: {actual} is below minimum {minimum}"
        )


class InvalidLevel(FheError):
    def __init__(self, level: int, min_level: int = 0, max_level: int = 0):
        super().__init__(
            f"Level {level} out of bounds: valid range is "
            f"[{min_level}, {max_level}]"
        )
        self.level = level


class SimdNotSupported(FheError):
    def __init__(self, reason: str):
        super().__init__(f"SIMD operations not supported: {reason}")


class UnsupportedOperation(FheError):
    def __init__(self, reason: str):
        super().__init__(reason)


class ParametersError(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Parameters error: {reason}")


class InvalidCiphertext(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Invalid ciphertext: {reason}")


class InvalidPlaintext(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Invalid plaintext: {reason}")


class InvalidSecretKey(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Invalid secret key: {reason}")


class InvalidGaloisElement(FheError):
    def __init__(self, element: int, reason: str):
        super().__init__(f"Invalid Galois element {element}: {reason}")


class InvalidRotationStep(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Invalid rotation step: {reason}")


class DimensionMismatch(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Dimension mismatch: {reason}")


class SerializationError(FheError):
    def __init__(self, reason: str):
        super().__init__(f"Serialization error: {reason}")


class UnexpectedError(FheError):
    def __init__(self, message: str):
        super().__init__(f"Unexpected error: {message}")
