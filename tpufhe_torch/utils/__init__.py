"""Host-side utilities: primality, prime generation, RNGs, sampling."""

from tpufhe_torch.utils.misc import inverse
from tpufhe_torch.utils.primes import generate_prime, is_prime, supports_opt
from tpufhe_torch.utils.sampling import sample_vec_cbd

__all__ = [
    "is_prime",
    "generate_prime",
    "supports_opt",
    "sample_vec_cbd",
    "inverse",
]
