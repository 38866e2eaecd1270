"""Multiparty (threshold) BFV, after Mouchet et al. eprint 2020/304: the
port of tpufhe's mbfv package.

Share types for the EncKeyGen, RelinKeyGen (2 rounds), KeySwitch,
Decryption and PubKeySwitch protocols, aggregated by summation
(protocols.py), and the batched all-parties programs with the aggregation
over torch.distributed (batched.py).
"""

from tpufhe_torch.mbfv.protocols import (
    CommonRandomPoly,
    DecryptionShare,
    PublicKeyShare,
    PublicKeySwitchShare,
    RelinKeyGenerator,
    RelinKeyShare,
    SecretKeySwitchShare,
    aggregate,
)

__all__ = [
    "CommonRandomPoly",
    "PublicKeyShare",
    "RelinKeyGenerator",
    "RelinKeyShare",
    "SecretKeySwitchShare",
    "DecryptionShare",
    "PublicKeySwitchShare",
    "aggregate",
]
