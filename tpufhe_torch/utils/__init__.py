"""Host-side utilities: primality, prime generation, transcoding, RNGs,
sampling."""

from tpufhe_torch.utils.misc import inverse, variance
from tpufhe_torch.utils.primes import generate_prime, is_prime, supports_opt
from tpufhe_torch.utils.sampling import sample_vec_cbd
from tpufhe_torch.utils.transcode import (
    transcode_bidirectional,
    transcode_from_bytes,
    transcode_to_bytes,
)

__all__ = [
    "is_prime",
    "generate_prime",
    "supports_opt",
    "transcode_to_bytes",
    "transcode_from_bytes",
    "transcode_bidirectional",
    "sample_vec_cbd",
    "inverse",
    "variance",
]
