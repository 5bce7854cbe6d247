"""The benchmark's command: one run of one cell.

    python3 radiobench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the run's record as one JSON line, then the result as the last
line of standard output; the numbers compared, each beside its limit, are
also the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), and
when a JAX module is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from radiobench import harness
    chips = harness.cell_files(harness.benchmark(),
                               args.workload)["entry"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"radiobench: the cell needs {chips} CUDA card(s); {have} "
              f"available", file=sys.stderr)
        return 2
    result, rec = harness.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"radiobench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if "error" in rec:
        print(f"radiobench: {rec['error']}", file=sys.stderr)
    print(json.dumps(rec), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
