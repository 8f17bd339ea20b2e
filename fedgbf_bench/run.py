"""Run one cell of the FedGBF benchmark once and print its result.

    python3 fedgbf_bench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout: loads, warms the cell's own shapes, measures
for ``--seconds`` (``--trace 1``: traces a fixed amount of the cell's work
instead), compares what the window produced with the plain reference, and
prints as its last line one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit).  The host is
described on an earlier line.  Exits non-zero, printing no result, without
as many CUDA cards as the cell asks for, or if JAX or the JAX package was
loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is the program under test)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_line() -> dict:
    import torch

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip():
                    break
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    cpu = " ".join(f"{k} {fields[k]}" for k in (
        "model name", "vendor_id", "cpu family", "model", "cpu MHz")
        if k in fields) or platform.machine()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = "nvidia-smi not available"
    return {"cpu": cpu, "cores": os.cpu_count(), "card": card,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch

    from fedgbf_bench import bench
    from fedgbf_bench import spec as spec_mod

    spec = spec_mod.load()
    faults = spec_mod.problems(spec)
    if faults:
        print("BENCHMARK.json: " + "; ".join(faults), file=sys.stderr)
        return 2
    cell = spec_mod.cell(spec, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{cards}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program; fails without src/)

    print(f"imports and the card: {time.perf_counter() - T_PROCESS:.3f} s",
          file=sys.stderr)

    limits = spec_mod.limits(args.workload)
    env = bench.environment(spec, args.workload, args.seed,
                            torch.device("cuda", 0))
    result = bench.execute(spec, env, args.seconds, bool(args.trace),
                           T_PROCESS, limits)
    print("host: " + json.dumps(host_line()), flush=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded JAX or the JAX package: {loaded}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"]}
    device.update(result["device"])
    result["device"] = device
    result["checks"] = result.pop("checks")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
