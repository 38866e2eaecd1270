"""The BFV scheme: parameters, plaintexts, ciphertexts, keys, operations."""

from tpufhe_torch.bfv.ciphertext import Ciphertext
from tpufhe_torch.bfv.encoding import Encoding
from tpufhe_torch.bfv.keys import (
    EvaluationKey,
    EvaluationKeyBuilder,
    GaloisKey,
    KeySwitchingKey,
    PublicKey,
    RelinearizationKey,
    SecretKey,
)
from tpufhe_torch.bfv.ops import (
    Multiplicator,
    ct_add,
    ct_add_pt,
    ct_mul,
    ct_mul_pt,
    ct_neg,
    ct_square,
    ct_sub,
    ct_sub_pt,
    dot_product_scalar,
)
from tpufhe_torch.bfv.parameters import (
    BfvParameters,
    BfvParametersBuilder,
    PlaintextModulus,
)
from tpufhe_torch.bfv.plaintext import Plaintext, PlaintextVec
from tpufhe_torch.bfv.rgsw import RGSWCiphertext

__all__ = [
    "BfvParameters",
    "BfvParametersBuilder",
    "PlaintextModulus",
    "Encoding",
    "Plaintext",
    "PlaintextVec",
    "Ciphertext",
    "RGSWCiphertext",
    "SecretKey",
    "PublicKey",
    "KeySwitchingKey",
    "RelinearizationKey",
    "GaloisKey",
    "EvaluationKey",
    "EvaluationKeyBuilder",
    "Multiplicator",
    "ct_add",
    "ct_sub",
    "ct_neg",
    "ct_add_pt",
    "ct_sub_pt",
    "ct_mul",
    "ct_mul_pt",
    "ct_square",
    "dot_product_scalar",
]
