"""Time small kernel launches with and without the host's launch path.

    python3 scripts/graph_times.py [OTHER_CHECKOUT]

For each case, the wrapper's call is timed twice on the card with CUDA
events: eagerly, 20 calls after a warm-up (as chip_smoke.py's phase 3
times every kernel), and as the replay of a CUDA graph that captured the
same 20 calls, which leaves out the host's work per call (the wrapper's
checks, allocation and the ctypes launch). Where the eager time is well
above the replay's, the call is bound by the host, not by the kernel.

The cases are ks_accumulate at the N = 16384, 6 x 62-bit batch-16
relinearization (two addends) and at the narrow 7 x 30-bit batch-32
rotation (one addend), and ct_pt_dot at the dot bench's shape (128 terms,
4 x 62-bit, N = 8192) and at 15 terms over 3 x 62-bit. With OTHER_CHECKOUT
(a checkout of another commit), the cases run in turns, this tree, the
other, the other, this tree, each in a process of its own importing its
own tpufhe_torch; a case the other tree has no wrapper for is skipped
there. Prints the card's name and power limit, one line per case and run,
then one JSON line with every time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def cases(gen):
    """(label, call) pairs; a call launches one kernel through its wrapper."""
    from tpufhe_torch import pipeline
    from tpufhe_torch.bfv import BfvParametersBuilder
    from tpufhe_torch.bfv.keys.key_switching_key import shoup_of

    def params(n, sizes):
        return (BfvParametersBuilder().set_degree(n)
                .set_plaintext_modulus(65537).set_moduli_sizes(sizes).build())

    def residues(shape, ctx):
        p = ctx.tables.p[:, None].long()
        x = torch.randint(0, 2 ** 62, shape, device="cuda", generator=gen) % p
        return x.to(ctx.dtype)

    def key(ctx):
        k = SimpleNamespace(c0=residues((ctx.k, ctx.k, ctx.degree), ctx),
                            c1=residues((ctx.k, ctx.k, ctx.degree), ctx),
                            log_base=0)
        k.c0_shoup, k.c1_shoup = (shoup_of(k.c0, ctx.moduli),
                                  shoup_of(k.c1, ctx.moduli))
        return k

    out = []
    for label, n, sizes, batch, addends in (
            ("ks_accumulate N = 16384 relin", 16384, [62] * 6, 16, 2),
            ("ks_accumulate narrow rotation", 8192, [30] * 7, 32, 1)):
        ctx = params(n, sizes).context_at_level(0)
        d = residues((ctx.k, batch, ctx.k, n), ctx)
        adds = [residues((batch, ctx.k, n), ctx) for _ in range(addends)]
        kk = key(ctx)
        out.append((label, lambda ctx=ctx, d=d, kk=kk, adds=adds:
                    pipeline.ks_accumulate_cuda(ctx, d, kk, *adds)))
    try:
        from tpufhe_torch.ops import dot
    except ImportError:
        return out
    for label, sizes, terms in (("ct_pt_dot dot bench", [62] * 4, 128),
                                ("ct_pt_dot 15 terms", [62] * 3, 15)):
        ctx = params(8192, sizes).context_at_level(0)
        parts = [residues((terms, 1, ctx.k, 8192), ctx) for _ in range(2)]
        db = residues((terms, 1, ctx.k, 8192), ctx)
        out.append((label, lambda ctx=ctx, parts=parts, db=db:
                    dot.ct_pt_dot_cuda(ctx, parts, db)))
    return out


def event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def measure() -> dict:
    """{label: (eager ms, graph ms)} per call, in this process's tree."""
    gen = torch.Generator(device="cuda").manual_seed(2026)
    out = {}
    for label, call in cases(gen):
        call()
        torch.cuda.synchronize()

        def eager(call=call):
            for _ in range(REPS):
                call()

        eager()
        torch.cuda.synchronize()
        eager_ms = event_ms(eager) / REPS
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            eager()  # warm the allocator's pool on the capture stream
            with torch.cuda.graph(graph, stream=stream):
                eager()
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
        out[label] = (eager_ms, event_ms(graph.replay) / REPS)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_times: no CUDA device", file=sys.stderr)
        return 2
    if os.environ.get("GRAPH_TIMES_CHILD"):
        print(json.dumps(measure()))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    trees = [ROOT]
    if len(sys.argv) > 1:
        other = os.path.abspath(sys.argv[1])
        trees = [ROOT, other, other, ROOT]
    runs = []
    for i, tree in enumerate(trees):
        env = dict(os.environ, GRAPH_TIMES_CHILD="1", PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                              cwd=tree, env=env, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        name = "this tree" if tree == ROOT else os.path.relpath(tree, ROOT)
        for label, (eager_ms, graph_ms) in times.items():
            print(f"run {i + 1} ({name}) {label}: eager {eager_ms:.4f} ms, "
                  f"graph replay {graph_ms:.4f} ms a call")
        runs.append({"tree": name, "times": times})
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
