"""Read the check's numbers over many seeds in one process, for the
program as it serves (``--arm program``) or for its control (``--arm
control``: the program with its int8-activation paths on, W4A8 decode,
W8A8 prefill and, for the 7B, int8 towers). Each seed builds its own
weights, runs the cell's first batch at the cell's own size and load
(``--seconds 0``: the window holds one batch) and compares a run's sample
with the reference. The limits in ``workloads/<cell>.json`` are set from
these readings: above the program's largest, below the control's
smallest.

    python3 port_bench/control.py --workload <cell> --arm control \
        --seeds 11,12,13 [--seconds 0]

One JSON line a seed on standard output."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--arm", choices=("program", "control"),
                        required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=0.0)
    opts = parser.parse_args(argv)

    import torch

    from port_bench import core

    if not torch.cuda.is_available():
        core.log("no CUDA card")
        return 2
    for seed in (int(s) for s in opts.seeds.split(",")):
        t = time.perf_counter()
        out, found = core.run_cell(ROOT, opts.workload, seed, opts.seconds, False,
                            "cuda", t, control=opts.arm == "control")
        print(json.dumps({
            "workload": opts.workload, "arm": opts.arm, "seed": seed,
            "numbers": found,
            "failed": out["failed"], "attempted": out["attempted"],
            "seconds": time.perf_counter() - t,
            "memory_peak_bytes": out["device"]["memory_peak_bytes"]}),
            flush=True)
        torch.cuda.reset_peak_memory_stats()
    core.log(f"all seeds in {time.perf_counter() - T0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
