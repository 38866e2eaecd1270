"""The median per query batch of the benchmark's spans around the
queries' Ciphertext.from_bytes (with the stacking of their parts) and the
answers' to_bytes (host clock): wire_in plus wire_out."""

from fhebench.metrics._stats import median


def read(w, name):
    return median([a + b for a, b in zip(w.spans.get("wire_in", []),
                                         w.spans.get("wire_out", []))])
