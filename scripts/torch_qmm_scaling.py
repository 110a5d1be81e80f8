"""Time the tiled quantized matmuls of the PyTorch port against K on one card.

    python3 scripts/torch_qmm_scaling.py [--tree DIR] [--m 5948] [--n 5120]

For K1 (``int4_matmul_2d``), K1v3 (``int4_matmul_2d_v3``) and K6
(``int8_matmul_2d``) at M rows and N columns, times one call at several K
(CUDA events around ``--reps`` warm calls; random weights from a seed) and
fits ms = a + b K by least squares. A block walks the whole of K, so with
W waves of blocks (ceil(blocks / SM count)) the fit splits a call into
a / W ms of fixed cost per block (first copies, first dequantization, the
epilogue's stores) and the steady state b, printed as TFLOP/s and as its
share of the card's published 989 TFLOP/s bf16 rate. ``--tree`` names the
checkout whose ``a3vlm_tpu_torch`` is imported (default: the one holding
this script). The last line is one JSON object of these numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PEAK_FLOPS_PER_S = 989e12
KS = (1024, 2048, 5120, 10240, 14336)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parents[1]))
    parser.add_argument("--m", type=int, default=5948)
    parser.add_argument("--n", type=int, default=5120)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    sys.path.insert(0, str(Path(opts.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this timing runs on the GPU only")
    from a3vlm_tpu_torch.ops import _kernels
    from a3vlm_tpu_torch.ops import quant_matmul as qmm
    from a3vlm_tpu_torch.quant import _quantize_leaf_int4, _quantize_leaf_int8

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    _kernels.lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(opts.seed)
    M, N = opts.m, opts.n

    def timed_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(opts.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / opts.reps

    # name -> (rows of x per block, ms at each K)
    rows = {"int4_matmul": (256, []), "int4_matmul_v3": (128, []),
            "int8_matmul": (256, [])}
    for K in KS:
        w = (torch.rand(K, N, generator=gen, device="cuda") * 2 - 1)
        w = (w / K ** 0.5).to(torch.bfloat16)
        q4, q8 = _quantize_leaf_int4(w), _quantize_leaf_int8(w)
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        args = (x, q4.q, q4.scale, q4.group)
        rows["int4_matmul"][1].append(
            timed_ms(lambda: qmm.int4_matmul_2d(*args)))
        rows["int4_matmul_v3"][1].append(
            timed_ms(lambda: qmm.int4_matmul_2d_v3(*args)))
        rows["int8_matmul"][1].append(
            timed_ms(lambda: qmm.int8_matmul_2d(x, q8.q, q8.scale)))
        del w, q4, q8, x

    result = {"card": card, "M": M, "N": N, "K": list(KS), "kernels": {}}
    mean_k = sum(KS) / len(KS)
    for name, (bm, ms) in rows.items():
        mean_ms = sum(ms) / len(ms)
        b = (sum((k - mean_k) * (t - mean_ms) for k, t in zip(KS, ms))
             / sum((k - mean_k) ** 2 for k in KS))
        a = mean_ms - b * mean_k
        blocks = -(-M // bm) * -(-N // 128)
        waves = -(-blocks // sms)
        rate = 2 * M * N / (b * 1e-3)  # operations per second, steady state
        result["kernels"][name] = {
            "ms": ms, "fixed_ms": a, "ms_per_k": b, "block_rows": bm,
            "waves": waves, "fixed_us_per_block": a / waves * 1e3,
            "steady_tflops": rate / 1e12,
            "steady_share_of_peak": rate / PEAK_FLOPS_PER_S,
        }
        print(f"[{card}] {name:15s} M={M} N={N} K={list(KS)}: ms "
              f"{[round(t, 4) for t in ms]}; fit {a:.4f} ms + {b * 1e3:.4f} "
              f"us/K; {waves} waves of {bm}-row blocks: "
              f"{a / waves * 1e3:.1f} us fixed a block, steady "
              f"{rate / 1e12:.0f} TFLOP/s "
              f"({rate / PEAK_FLOPS_PER_S:.0%} of 989)")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
