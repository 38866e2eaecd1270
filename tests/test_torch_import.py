"""tpufhe_torch stands alone: importing it pulls in neither JAX nor tpufhe."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax_and_no_tpufhe():
    code = (
        "import sys\n"
        "import tpufhe_torch, tpufhe_torch.bfv, tpufhe_torch.pipeline\n"
        "import tpufhe_torch.convert, tpufhe_torch.kernels\n"
        "import tpufhe_torch.bfv.ops, tpufhe_torch.bfv.keys.evaluation_key\n"
        "import tpufhe_torch.bfv.keys.galois_key, tpufhe_torch.native\n"
        "import tpufhe_torch.ops.intt_scale, tpufhe_torch.ops.zq32\n"
        "from tpufhe_torch.utils import rngs, sampling, obs, transcode\n"
        "import tpufhe_torch.serialize, tpufhe_torch.traits\n"
        "import tpufhe_torch.bfv.rgsw, tpufhe_torch.models\n"
        "import tpufhe_torch.mbfv, tpufhe_torch.mbfv.batched\n"
        "import tpufhe_torch.models.voting\n"
        "import tpufhe_torch.parallel, tpufhe_torch.parallel.seq_pipeline\n"
        "import tpufhe_torch.parallel.ntt_dist, tpufhe_torch.parallel.sharding\n"
        "assert tpufhe_torch.native.lib() is not None, tpufhe_torch.native.error\n"
        "assert tpufhe_torch.native.available()\n"
        "rngs.ChaCha8Rng(rngs.seed_from_u64(1)).fill_bytes(1000)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tpufhe' or m.startswith('tpufhe.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sources_never_import_tpufhe_or_jax():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:tpufhe(?!_torch)\b|jax\b)", re.MULTILINE)
    files = sorted((ROOT / "tpufhe_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for new in ("bfv/ops.py", "bfv/keys/galois_key.py",
                "bfv/keys/evaluation_key.py", "native/__init__.py",
                "ops/intt_scale.py", "ops/zq32.py", "serialize/codecs.py",
                "serialize/proto.py", "models/pir.py", "models/util.py",
                "bfv/rgsw.py", "traits.py", "utils/transcode.py",
                "mbfv/__init__.py", "mbfv/protocols.py", "mbfv/batched.py",
                "models/voting.py", "parallel/__init__.py",
                "parallel/ntt_dist.py", "parallel/seq_pipeline.py",
                "parallel/sharding.py"):
        assert ROOT / "tpufhe_torch" / new in files
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert not offenders, offenders
