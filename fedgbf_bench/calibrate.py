"""The readings a cell's comparison limits are set from, at the cell's own
size: the program's sound runs over many seeds (the lower readings), the
control (the plain reference in bfloat16 in the program's place) and each
planted fault (``faults.py``) over a few seeds (the upper readings).  The
benchmark's own runs never run this.

    python3 fedgbf_bench/calibrate.py --workload credit.train.local \
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9 \
        [--seconds 2] [--out calibrate.jsonl]

A training seed runs set-up (with its warm job) and one more job; a
scoring seed a window of ``--seconds``.  Prints one JSON line a reading,
then the largest sound and the smallest control and fault reading of
each number.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch

    from fedgbf_bench import bench, faults
    from fedgbf_bench import spec as spec_mod

    spec = spec_mod.load()
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def one(seed, what, plant=None):
        env = bench.environment(spec, args.workload, seed, device)
        drv = spec_mod.driver(env.traffic["kind"])
        t0 = time.perf_counter()
        state = drv.setup(env)
        if what == "control":
            numbers = drv.control(env, state)
        else:
            with plant() if plant else contextlib.nullcontext():
                facts = drv.run(state, seconds=args.seconds,
                                count=1 if env.traffic["kind"] == "train_jobs"
                                else None)
            outputs = drv.collect(state, facts)
            drv.release(state)
            numbers = drv.check(env, state, outputs)
        emit({"cell": args.workload, "what": what, "seed": seed,
              "numbers": numbers, "seconds": time.perf_counter() - t0})
        return numbers

    sound, upper = {}, {}
    for seed in _seeds(args.seeds):
        for k, v in one(seed, "sound").items():
            sound[k] = max(sound.get(k, 0.0), v)
    traffic = spec_mod.traffic(spec_mod.cell(spec, args.workload)["traffic"])
    runs = [("control", None)] + list(faults.applicable(traffic).items())
    for what, plant in runs:
        seeds = _seeds(args.control_seeds if what == "control"
                       else args.fault_seeds)
        for seed in seeds:
            for k, v in one(seed, what, plant).items():
                if v is None:
                    continue
                cur = upper.setdefault(k, {}).get(what)
                upper[k][what] = v if cur is None else min(cur, v)
    emit({"cell": args.workload, "what": "summary", "lower": sound,
          "upper": upper, "card": torch.cuda.get_device_name(0)
          if device.type == "cuda" else "cpu"})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
