"""The port's distributed NTT (tpufhe_torch/parallel/ntt_dist.py) against
the single-device transforms and against tpufhe's DistNtt.

- The per-shard halves in one process, the exchange done by stacking,
  against forward_plain / backward_plain at degrees 16 to 2048 over 1, 2, 4
  and 8 shards (blocks down to K1's shortest row, 8 words), also on a limb
  slice and, for the forward, on words in [0, 4p).
- DistNtt over gloo: 8 worker processes that import only tpufhe_torch (a
  FileStore under the test's tmp_path, no TCP port, a 60 s process-group
  timeout, a 120 s wait for the whole run, a log file a worker), at
  N = 2048 on tpufhe's MODULI_3, plain, batched and lazy, held word for
  word against tpufhe's DistNtt on conftest's 8-device CPU mesh
  (tests/test_ntt_dist.py's cases).
- The errors: no process group, shards that do not divide N, blocks below
  8 words, a narrow context.

``run_gloo`` is shared with tests/test_torch_parallel.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpufhe.ops import rq as jrq
from tpufhe.parallel.ntt_dist import DistNtt as JDistNtt

from tpufhe_torch import convert
from tpufhe_torch.bfv import BfvParametersBuilder
from tpufhe_torch.ops.ntt import backward_plain, forward_plain
from tpufhe_torch.ops.rq import Context
from tpufhe_torch.parallel import ntt_dist as nd

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 120  # seconds a gloo run may take, start-up included
MODULI_3 = [0x3FFFFFFF000001, 4611686018326724609, 1152921504606584833]

PREAMBLE = r"""
import json, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(work + "/store", world),
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=60))
ns = {"rank": rank, "world": world, "torch": torch, "np": np, "out": {},
      "spec": json.load(open(work + "/spec.json")),
      "data": dict(np.load(work + "/in.npz"))}
exec(open(work + "/body.py").read(), ns)
out = ns["out"]
# the body's objects hold process groups: release them while the process
# runs, not in the interpreter's teardown
ns.clear()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpufhe")]
assert not bad, bad
np.savez(f"{work}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def run_gloo(work: Path, world: int, body: str, spec: dict, data: dict
             ) -> list:
    """Run `body` in `world` gloo worker processes (rank, world, spec, data
    and torch in scope; it fills the dict `out` with numpy arrays) and
    return each rank's `out`. Fails, with the tails of the workers' logs,
    if a worker fails or the run outlasts WORKER_TIMEOUT in all. Each
    worker writes to its own log file, so none blocks on a full pipe."""
    work.mkdir()
    (work / "spec.json").write_text(json.dumps(spec))
    (work / "body.py").write_text(body)
    np.savez(work / "in.npz", **data)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    logs = [work / f"log{r}.txt" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", PREAMBLE, str(r), str(world),
                 str(work)], cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + WORKER_TIMEOUT
    late = False
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        late = True
    finally:
        for p in procs:
            p.kill()
            p.wait()

    def tails():
        return "\n".join(f"rank {r}: {log.read_text()[-2000:]}"
                         for r, log in enumerate(logs))

    if late:
        pytest.fail(f"the gloo workers outlasted {WORKER_TIMEOUT} s\n"
                    f"{tails()}")
    if any(p.returncode != 0 for p in procs):
        pytest.fail(f"worker exit codes {[p.returncode for p in procs]}\n"
                    f"{tails()}")
    return [dict(np.load(work / f"out{r}.npz")) for r in range(world)]


def _context(n: int, k: int) -> Context:
    return Context(tuple(BfvParametersBuilder.generate_moduli([62] * k, n)),
                   n, "cpu")


def _residues(ctx, shape, seed, bound=1):
    """(*shape, k, n) int64 words below bound * p_j in row j."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, bound * p, shape + (ctx.degree,),
                               dtype=np.uint64) for p in ctx.moduli], -2)
    return torch.from_numpy(x.view(np.int64))


def _stacked(x, plans, pre, post, sl=None):
    """Every rank's halves in one process, the exchange by stacking; the
    ranks' output blocks side by side."""
    b = plans[0].block
    sent = torch.stack([pre(x[..., e * b:(e + 1) * b], p, sl)
                        for e, p in enumerate(plans)])
    return torch.cat([post(sent, p, sl) for p in plans], dim=-1)


# (degree, shards): B = 8 at (16, 2) and (64, 8)
HALVES_CASES = [(16, 1), (16, 2), (64, 8), (256, 4), (512, 1), (1024, 2),
                (2048, 8)]


@pytest.mark.parametrize("n,shards", HALVES_CASES)
def test_halves_equal_the_single_device_transforms(n, shards):
    ctx = _context(n, 3)
    tb = ctx.tables
    plans = [nd.DistNttPlan.new(ctx, shards, e) for e in range(shards)]
    x = _residues(ctx, (2,), n + shards)
    got = _stacked(x, plans, nd.forward_pre, nd.forward_post)
    assert torch.equal(got, forward_plain(x, tb.omegas, tb.mod))
    got = _stacked(x, plans, nd.backward_pre, nd.backward_post)
    assert torch.equal(got, backward_plain(x, tb.zetas_inv, tb.ninv, tb.mod))
    # the extend's new limbs: a limb slice past limb 0
    sl = slice(1, 3)
    got = _stacked(x[..., sl, :], plans, nd.forward_pre, nd.forward_post, sl)
    assert torch.equal(got, forward_plain(x[..., sl, :], tb.omegas[sl],
                                          tb.mod[sl]))
    # the forward takes words in [0, 4p) (some above 2^63), as tpufhe's
    lazy = _residues(ctx, (2,), n + shards + 1, bound=4)
    got = _stacked(lazy, plans, nd.forward_pre, nd.forward_post)
    canon = torch.from_numpy((lazy.numpy().view(np.uint64)
                              % np.array(ctx.moduli, np.uint64)[:, None]
                              ).view(np.int64))
    assert torch.equal(got, forward_plain(canon, tb.omegas, tb.mod))


def test_shard_tables_are_gathered_per_stage():
    """Shard e's tables hold the whole ring's twiddles of its block's
    butterflies: forward stage m at m D + e m + g, the inverse's stage of
    half-width l at N - N / l + e B / (2 l) + g (its running offset)."""
    fwd, inv = nd.shard_indices(64, 4, 2)
    assert list(fwd) == [0, 6, 12, 13, 24, 25, 26, 27] + list(range(48, 56))
    assert list(inv) == (list(range(16, 24)) + [40, 41, 42, 43, 52, 53, 58]
                         + [63])


# ---------------------------------------------------------------------------
# DistNtt over gloo against tpufhe's DistNtt on the 8-device mesh
# ---------------------------------------------------------------------------

DIST_BODY = r"""
from tpufhe_torch.ops.rq import Context
from tpufhe_torch.parallel.ntt_dist import DistNtt
ntt = DistNtt(Context(tuple(spec["moduli"]), spec["n"], "cpu"))
b = spec["n"] // world
def block(name):
    return torch.from_numpy(data[name][..., rank * b:(rank + 1) * b].copy())
for name in ("x", "lazy", "batch"):
    out[name] = ntt.forward(block(name)).numpy()
out["back"] = ntt.backward(block("y")).numpy()
"""


def _pairs(rng, n, bound=1, lead=()):
    """tests/test_ntt_dist.py's inputs: (*lead, k, 2, n/128, 128) uint32
    lane pairs of words below bound * p."""
    vals = np.stack([rng.integers(0, bound * p, size=lead + (n,),
                                  dtype=np.uint64) for p in MODULI_3], -2)
    return convert.words_to_lanes(vals.view(np.int64))


@pytest.fixture(scope="module")
def tpufhe_dist():
    """tpufhe's DistNtt over conftest's 8-device CPU mesh at N = 2048:
    (inputs, outputs) as int64 words."""
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    n = 2048
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("seq",))
    dist_ntt = JDistNtt(jrq.Context(tuple(MODULI_3), n), mesh)
    rng = np.random.default_rng(3)
    ins = {"x": _pairs(rng, n), "lazy": _pairs(rng, n, 4),
           "batch": _pairs(rng, n, lead=(4,)), "y": _pairs(rng, n)}
    outs = {}
    for name in ("x", "lazy", "batch"):
        arr = jax.device_put(ins[name], dist_ntt.sharding(ins[name].ndim - 4))
        outs[name] = np.asarray(dist_ntt.forward(arr))
    arr = jax.device_put(ins["x"], dist_ntt.sharding(0))
    outs["x_lazy"] = np.asarray(dist_ntt.forward(arr, lazy=True))
    arr = jax.device_put(ins["y"], dist_ntt.sharding(0))
    outs["back"] = np.asarray(dist_ntt.backward(arr))
    words = {k: convert.lanes_to_words(v) for k, v in ins.items()}
    return words, {k: convert.lanes_to_words(v) for k, v in outs.items()}


def test_gloo_dist_ntt_matches_tpufhe_mesh(tpufhe_dist, tmp_path):
    ins, want = tpufhe_dist
    outs = run_gloo(tmp_path / "ntt", 8, DIST_BODY,
                    {"n": 2048, "moduli": MODULI_3}, ins)
    for name in ("x", "lazy", "batch", "back"):
        got = np.concatenate([o[name] for o in outs], axis=-1)
        np.testing.assert_array_equal(got, want[name], err_msg=name)


LAZY_BODY = r"""
from tpufhe_torch.ops.rq import Context
from tpufhe_torch.parallel.ntt_dist import DistNtt
ntt = DistNtt(Context(tuple(spec["moduli"]), spec["n"], "cpu"))
b = spec["n"] // world
x = torch.from_numpy(data["x"][..., rank * b:(rank + 1) * b].copy())
out["lazy"] = ntt.forward(x, lazy=True).numpy()
out["canonical"] = ntt.forward(x).numpy()
"""


def test_gloo_dist_ntt_lazy_forward_matches_tpufhe_mesh(tpufhe_dist,
                                                       tmp_path):
    """DistNtt.forward(lazy=True) over two gloo workers: tpufhe's lazy
    words (its 8-device mesh) below 4p and congruent to the port's, which
    the plain K1 on the CPU leaves canonical."""
    ins, want = tpufhe_dist
    outs = run_gloo(tmp_path / "lazy", 2, LAZY_BODY,
                    {"n": 2048, "moduli": MODULI_3}, {"x": ins["x"]})
    got = np.concatenate([o["lazy"] for o in outs], axis=-1)
    np.testing.assert_array_equal(
        got, np.concatenate([o["canonical"] for o in outs], axis=-1))
    np.testing.assert_array_equal(got, want["x"])
    p = np.array(MODULI_3, np.uint64)[:, None]
    lazy = want["x_lazy"].view(np.uint64)
    assert (lazy < 4 * p).all()
    np.testing.assert_array_equal(lazy % p, got.astype(np.uint64))


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


def test_dist_ntt_needs_a_process_group():
    ctx = _context(64, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError):
        nd.DistNtt(ctx)
    plan = nd.DistNttPlan.new(ctx, 2, 0)
    x = torch.zeros(1, 32, dtype=torch.int64)
    for shard_fn in (nd.dist_forward_shard, nd.dist_backward_shard):
        with pytest.raises(RuntimeError):
            shard_fn(x, plan, None)


def test_plan_rejects_shapes_it_cannot_split():
    ctx = _context(64, 1)
    with pytest.raises(ValueError):
        nd.DistNttPlan.new(ctx, 3, 0)  # 3 does not divide 64
    with pytest.raises(ValueError):
        nd.DistNttPlan.new(ctx, 16, 0)  # blocks of 4 words
    narrow = Context(tuple(BfvParametersBuilder.generate_moduli([30], 64)),
                     64, "cpu", narrow=True)
    with pytest.raises(ValueError):
        nd.DistNttPlan.new(narrow, 2, 0)
    plan = nd.DistNttPlan.new(ctx, 2, 1)
    with pytest.raises(ValueError):
        nd.forward_pre(torch.zeros(1, 64, dtype=torch.int64), plan)
