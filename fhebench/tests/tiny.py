"""A checkout of the benchmark with every configuration and mix cut to a
size the CPU runs in seconds: the same files, the same names, smaller
numbers. The tests run cells there with the program on the CPU."""

from __future__ import annotations

import json
import os
import shutil

from fhebench.run import ROOT

# degree 64 keeps every modulus and plaintext modulus of the
# configurations NTT-friendly and every SIMD encoding defined
TINY_CONFIG = {"degree": 64, "database_size": 300, "element_size": 8}
TINY_MIX = {"pool": 3, "check_steps": 1, "check_rows": 4, "check_queries": 4}
TINY_BATCH = 4


def tiny_checkout(tmp) -> str:
    """A copy of BENCHMARK.json and fhebench/'s data files under tmp, cut
    to the tiny sizes; the code stays where it is."""
    root = os.path.join(str(tmp), "checkout")
    os.makedirs(os.path.join(root, "fhebench"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for sub, cut in (("configs", TINY_CONFIG), ("workloads", TINY_MIX)):
        src = os.path.join(ROOT, "fhebench", sub)
        dst = os.path.join(root, "fhebench", sub)
        os.makedirs(dst, exist_ok=True)
        for name in os.listdir(src):
            with open(os.path.join(src, name)) as f:
                data = json.load(f)
            for key, value in cut.items():
                if key in data:
                    data[key] = value
            if data.get("batch", 0) > 1:
                data["batch"] = TINY_BATCH
            with open(os.path.join(dst, name), "w") as f:
                json.dump(data, f)
    return root
