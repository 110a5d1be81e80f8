"""Run one cell of the port's benchmark once, on the card(s) of this machine.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON object, the last line of standard output;
the numbers the check compared, each beside its limit, are the last lines
of standard error. With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. Exits 2,
printing no result, without enough CUDA cards for the cell, and 3 if JAX
or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# libraries the port may load must not bring JAX in with them
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = parser.parse_args(argv)

    import torch

    from port_bench import core

    chips = core.cell_spec(ROOT, opts.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"{opts.workload} needs {chips} CUDA card(s); this machine "
                 f"has {torch.cuda.device_count()}")
        return 2
    out, _ = core.run_cell(ROOT, opts.workload, opts.seed, opts.seconds,
                        bool(opts.trace), "cuda", T_START)
    bad = core.forbidden_modules()
    if bad:
        core.log(f"loaded in this process: {', '.join(bad)}")
        return 3
    for name, c in out["check"].items():
        core.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
