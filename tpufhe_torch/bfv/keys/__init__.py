from tpufhe_torch.bfv.keys.evaluation_key import EvaluationKey, EvaluationKeyBuilder
from tpufhe_torch.bfv.keys.galois_key import GaloisKey
from tpufhe_torch.bfv.keys.key_switching_key import KeySwitchingKey
from tpufhe_torch.bfv.keys.public_key import PublicKey
from tpufhe_torch.bfv.keys.relinearization_key import RelinearizationKey
from tpufhe_torch.bfv.keys.secret_key import SecretKey

__all__ = ["SecretKey", "PublicKey", "KeySwitchingKey", "RelinearizationKey",
           "GaloisKey", "EvaluationKey", "EvaluationKeyBuilder"]
