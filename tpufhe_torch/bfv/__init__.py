"""The BFV scheme: parameters, plaintexts, ciphertexts, keys."""

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.encoding import Encoding
from tpufhe_torch.bfv.keys import (
    EvaluationKey,
    EvaluationKeyBuilder,
    GaloisKey,
    KeySwitchingKey,
    RelinearizationKey,
    SecretKey,
)
from tpufhe_torch.bfv.ops import ct_add, ct_sub
from tpufhe_torch.bfv.parameters import (
    BfvParameters,
    BfvParametersBuilder,
    PlaintextModulus,
)
from tpufhe_torch.bfv.plaintext import Plaintext

__all__ = [
    "BfvParameters",
    "BfvParametersBuilder",
    "PlaintextModulus",
    "Encoding",
    "Plaintext",
    "Ciphertext",
    "SecretKey",
    "KeySwitchingKey",
    "RelinearizationKey",
    "GaloisKey",
    "EvaluationKey",
    "EvaluationKeyBuilder",
    "ct_add",
    "ct_sub",
]
