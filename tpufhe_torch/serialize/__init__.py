"""Wire-compatible serialization of polys, ciphertexts, keys and parameters
(fhe-math/src/proto/rq.proto, fhe/src/proto/bfv.proto; tpufhe's
serialize package), with the reference's seed compression: a fresh
ciphertext's last part and a key-switching key's c1 chain stored as their
32-byte ChaCha8 seeds and regenerated on load (ciphertext.rs:184-189,
key_switching_key.rs:332-406)."""

from tpufhe_torch.serialize.codecs import (
    deserialize_ciphertext,
    deserialize_evaluation_key,
    deserialize_galois_key,
    deserialize_ksk,
    deserialize_parameters,
    deserialize_poly,
    deserialize_public_key,
    deserialize_relinearization_key,
    deserialize_rgsw,
    deserialize_secret_key,
    serialize_ciphertext,
    serialize_evaluation_key,
    serialize_galois_key,
    serialize_ksk,
    serialize_parameters,
    serialize_poly,
    serialize_public_key,
    serialize_relinearization_key,
    serialize_rgsw,
    serialize_secret_key,
)

__all__ = [n for n in dir() if n.startswith(("serialize_", "deserialize_"))]
