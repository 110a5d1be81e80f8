"""The verify-window kernels (K5, K5q) of the PyTorch port on one GPU: device
time against the split count, and the wrapper's host time.

    python3 scripts/torch_verify_sweep.py [--splits 1,2,3,4,5,7,9,13]

For the latency path's cache (Hkv 40, S 1544; batch 1 at span 8, batch 4
at spans 8 and 16) and one GQA cache (Hkv 8, G 5, span 16), it times the
bf16 and the int8 kernel at each split count through CUDA graphs of 20
launches (device time alone: the combine pass included, no host time), and
marks the count that the wrapper's rule (``verify_splits``) picks on this
card. Then, at batch 1 and span 8, the host time per call (a loop of 200
calls, no synchronisation inside) of the wrapper, of its C entry point
alone, and of one ``scaled_dot_product_attention`` call on the same inputs.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from a3vlm_tpu_torch.ops import _kernels  # noqa: E402
from a3vlm_tpu_torch.ops import decode_attention as dec  # noqa: E402

D = 128
SCALE_LOG2 = 1.4426950408889634 / math.sqrt(D)


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Best mean device time of ``fn`` over ``reps`` replays of a CUDA
    graph of ``n`` calls."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def host_us(fn, n: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / n * 1e6


def case(B, span, G, Hkv, S=1544, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q = randn(B, span, Hkv * G, D)
    ck, cv = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    valid = torch.tensor([1500, 1510, 1530, 1540][:B], dtype=torch.int32,
                         device="cuda")
    kq = dec.QuantizedKV(*dec.quantize_kv_tokens(ck.transpose(1, 2)))
    vq = dec.QuantizedKV(*dec.quantize_kv_tokens(cv.transpose(1, 2)))
    return q, ck, cv, kq, vq, valid


def launcher(lib, q, k, v, valid, part, out, G, S, P):
    """The C entry point at split count P (no wrapper), on the stream that
    is current when it is called (a graph's capture stream, too)."""
    B, span = q.shape[:2]
    Hkv = q.shape[2] // G
    tail = (valid.data_ptr(), part.data_ptr(), out.data_ptr(), B, Hkv, G,
            span, S, P, SCALE_LOG2)
    if isinstance(k, dec.QuantizedKV):
        return lambda: lib.a3_verify_attend_q8(
            q.data_ptr(), k.qv.data_ptr(), v.qv.data_ptr(),
            k.scale.data_ptr(), v.scale.data_ptr(), *tail, _kernels.stream())
    return lambda: lib.a3_verify_attend(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), *tail,
                                        _kernels.stream())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--splits", default="1,2,3,4,5,7,9,13")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on the GPU only")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    lib = _kernels.lib()
    splits = [int(x) for x in opts.splits.split(",")]
    S = 1544
    for B, span, G, Hkv in ((4, 16, 1, 40), (1, 8, 1, 40), (4, 8, 1, 40),
                            (4, 16, 5, 8)):
        q, ck, cv, kq, vq, valid = case(B, span, G, Hkv, S)
        R = G * span
        part = torch.empty(B * Hkv * R * max(splits) * (D + 2),
                           device="cuda")
        out = torch.empty_like(q)
        rows = int(valid.sum())
        for kind, k, v, row_bytes in (("bf16", ck, cv, 2 * D),
                                      ("int8", kq, vq, D + 4)):
            quant = kind == "int8"
            bound = 2 * rows * Hkv * row_bytes / 3.35e12 * 1e3
            rule = dec.verify_splits(
                B, Hkv, R, S, dec._verify_slots(lib, q.get_device(), quant,
                                                R))
            times = []
            for P in splits:
                ms = graph_ms(launcher(lib, q, k, v, valid, part, out, G, S,
                                       P))
                times.append(f"P{P}{'*' if P == rule else ''} {ms:.4f}")
            print(f"B{B} span{span} G{G} Hkv{Hkv} {kind} (bound {bound:.4f} "
                  f"ms; * = the wrapper's split count {rule}): "
                  + ", ".join(times), flush=True)

    q, ck, cv, _, _, valid = case(1, 8, 1, 40, S)
    P = dec.verify_splits(1, 40, 8, S,
                          dec._verify_slots(lib, q.get_device(), False, 8))
    part = torch.empty(40 * 8 * P * (D + 2), device="cuda")
    out = torch.empty_like(q)
    qb = q.transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :]
            < (valid.long()[:, None] - 7
               + torch.arange(8, device="cuda")[:, None]))[None, None]
    wrapper = host_us(lambda: dec.verify_attention(q, ck, cv, valid))
    entry = host_us(launcher(lib, q, ck, cv, valid, part, out, 1, S, P))
    library = host_us(lambda: F.scaled_dot_product_attention(
        qb, ck, cv, attn_mask=mask))
    print(f"host us a call, B1 span8 Hkv40 S{S}: wrapper {wrapper:.1f}, "
          f"C entry point alone {entry:.1f}, scaled_dot_product_attention "
          f"{library:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
