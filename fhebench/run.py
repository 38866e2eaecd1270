"""Run one cell of the benchmark once and print its result line.

    python -m fhebench.run --workload NAME --seed N --seconds S --trace 0|1

Everything a cell is comes from files found by name: BENCHMARK.json (at
the checkout's root) names the cell's configuration and traffic mix;
fhebench/configs/<config>.json holds the parameters, fhebench/workloads/
<traffic>.json the mix and the driver that serves it (fhebench/traffic/
<driver>.py), and each metric of BENCHMARK.json that the cell reports is
read by fhebench/metrics/<name before the first dot>.py.

The run: set-up (import, the program's kernel build or load, keys,
inputs, warm-up of the cell's own shapes) is timed as setup_s; the window
runs for --seconds; with --trace 1 it runs under torch.profiler and the
launches' shapes are recorded for the rooflines (fhebench/trace.py). Then
the answers that the window produced are held against the reference
(fhebench/reference/), and one JSON line is printed last on stdout, with
each number compared beside its limit also on the last lines of stderr.
A run without a card, or with fewer cards than the cell asks for, exits
2 and prints no result; a run that finds JAX or the JAX package loaded
after its window exits 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with one host thread for the math libraries: a run's load
# stays steady, and torch's and NumPy's pools take no cores from the
# thread that launches the card's work
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufhe")


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def resolve(name: str, root: str = ROOT) -> tuple:
    """(BENCHMARK.json, workload entry, configuration, traffic mix) of the
    cell `name` in the checkout at `root`."""
    bench = load_json(root, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"fhebench: no workload {name!r} in BENCHMARK.json")
    config = load_json(root, "fhebench", "configs", f"{entry['config']}.json")
    mix = load_json(root, "fhebench", "workloads", f"{entry['traffic']}.json")
    return bench, entry, config, mix


def metrics_of(bench: dict, name: str, trace: bool) -> list:
    """The metric entries that cell `name` reports: its end-to-end ones
    (trace 0) or its per-layer ones (trace 1)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    """The reader of a metric: fhebench/metrics/<name before the dot>.py."""
    return importlib.import_module(
        f"fhebench.metrics.{metric.split('.')[0]}").read


def sm_clock() -> str:
    """The card's SM clock (nvidia-smi), beside a traced window: the int32
    multiply rate of the rooflines assumes the 1980 MHz boost clock."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unread"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str | None = None, root: str = ROOT) -> dict:
    """One run of cell `name` of the checkout at `root`: the result dict
    of the contract, with its checks. device "cpu" runs the program on
    the CPU (the tests); None on the card."""
    import torch

    from fhebench import trace as tracing

    torch.set_num_threads(1)
    bench, _, config, mix = resolve(name, root)
    driver = importlib.import_module(f"fhebench.traffic.{mix['driver']}")
    cell = driver.setup(config, mix, seed, device)
    cell.warm()
    rec = tracing.Recorder(trace, cell.on_card)
    clocked = trace and cell.on_card
    before = sm_clock() if clocked else None
    window = rec.run(cell, seconds)
    if clocked:
        print(f"fhebench: clocks.sm before and after the window: {before}, "
              f"{sm_clock()} MHz", file=sys.stderr)
    window.setup_s = rec.t_start - _T0
    out_metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"])(window, m["name"])
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cell.on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if cell.on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cell.on_card else 0)}
    if window.trace is not None:
        dev["busy_s"] = window.trace.busy_s
        dev["window_s"] = window.trace.window_s
    answers = cell.answers()
    cell.free()
    del cell
    if dev["platform"] == "gpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check(config, mix, seed, answers)
    print(f"fhebench: the reference's check took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct,
              "attempted": window.attempted, "failed": window.failed,
              "metrics": out_metrics, "device": dev}
    if window.trace is not None:
        result["breakdown"] = window.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fhebench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _, entry, _, _ = resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("fhebench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"fhebench: {entry['chips']} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"fhebench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
