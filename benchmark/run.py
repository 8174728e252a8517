"""The benchmark of repsurf_torch on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the check's numbers beside their
limits as the last lines of standard error, and one JSON object as the last
line of standard output.  Exits with another code than 0, printing no
result, without enough CUDA devices, or when JAX or the JAX package was
loaded.  See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common, runner  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser("repsurf_torch benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = common.load_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {spec.chips} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    result, checks = runner.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                t_start=T_START)
    found = common.forbidden_loaded()
    if found:
        print(f"loaded in this process: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for line in runner.limit_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
