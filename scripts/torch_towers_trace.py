"""Trace the llama_ens5 vision towers of the PyTorch port on one CUDA card.

    python3 scripts/torch_towers_trace.py [--tree DIR] [--batch 1] [--reps 10]

Builds the towers of ``Ens5Config()`` at full width (CLIP ViT-L/14, EVA
ViT-g/14 and the Q-Former, ConvNeXt-XXL, DINOv2 ViT-g/14, the projectors)
on random weights from a seed, and sends ``--batch`` 448x448 images through
``ens5.build_image_tokens``, the call ``MetaModel.encode_images`` makes and
``last_stats["towers_ms"]`` times (batch 1, five crops, is the
single-request path). Prints, for warm calls:

- wall ms of each call: the host's clock around a call, synchronized on
  both sides, as ``MetaModel`` times the towers;
- the host's ms a call inside the tower-attention wrapper
  (``models.vit.vit_attention``, not synchronized) and its launches a call;
- from a ``torch.profiler`` trace (device activity only) of ``--trace-reps``
  calls: the device's ms and kernel launches a call, the heaviest kernels,
  and the device's idle share of the median wall time.

``--tree`` names the checkout whose ``a3vlm_tpu_torch`` is imported (default:
the one holding this script), so that two trees can be traced in turn on
one card. The last line is one JSON object of these numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parents[1]))
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--trace-reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this trace runs on the GPU only")
    from a3vlm_tpu_torch.config import Ens5Config
    from a3vlm_tpu_torch.models import convnext, ens5, qformer, vit
    from a3vlm_tpu_torch.ops import _kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"tree {tree}; torch {torch.__version__} cuda {torch.version.cuda}")
    _kernels.lib()

    cfg = Ens5Config()
    dev, dt = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    D = cfg.llama.dim

    def proj(in_dim):
        return {"linear": {"weight": torch.randn(in_dim, D, generator=gen,
                                                 device=dev).to(dt) * 0.02,
                           "bias": torch.zeros(D, dtype=dt, device=dev)},
                "ln": {"weight": torch.ones(D, dtype=dt, device=dev),
                       "bias": torch.zeros(D, dtype=dt, device=dev)}}

    params = {
        "clip": vit.init_vit_params(cfg.clip, dt, dev, gen),
        "blip2_vision": vit.init_vit_params(cfg.blip2_vision, dt, dev, gen),
        "qformer": qformer.init_qformer_params(cfg.qformer, dt, dev, gen),
        "convnext": convnext.init_convnext_params(cfg.convnext, dt, dev, gen),
        "dinov2": vit.init_vit_params(cfg.dinov2, dt, dev, gen),
        "qformer_proj": proj(cfg.qformer.hidden),
        "visual_proj": proj(cfg.ens_dim),
        "start_img": torch.rand(1, 1, D, generator=gen, device=dev).to(dt),
        "end_img": torch.rand(1, 1, D, generator=gen, device=dev).to(dt),
    }
    mean = torch.tensor(ens5.CLIP_MEAN, device=dev)
    std = torch.tensor(ens5.CLIP_STD, device=dev)
    pixels = torch.rand(opts.batch, 448, 448, 3, generator=gen, device=dev)
    images = ((pixels - mean) / std).to(dt)

    # host time inside the tower-attention wrapper, read through the name
    # the tower block calls
    wrapped = vit.vit_attention
    host = {"s": 0.0}

    def timed_wrapper(q, k, v):
        t0 = time.perf_counter()
        out = wrapped(q, k, v)
        host["s"] += time.perf_counter() - t0
        return out

    vit.vit_attention = timed_wrapper

    def call():
        return ens5.build_image_tokens(params, cfg, images, "auto")

    with torch.inference_mode():
        for _ in range(3):
            out = call()
        torch.cuda.synchronize()
        if not (out.shape == (opts.batch, cfg.image_words, D)
                and torch.isfinite(out).all()):
            raise AssertionError(f"image tokens {tuple(out.shape)} malformed "
                                 "or not finite")
        wall, wrapper_ms = [], []
        launches0 = wrapped.launches
        for _ in range(opts.reps):
            host["s"] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            wrapper_ms.append(host["s"] * 1e3)
        k10_calls = (wrapped.launches - launches0) / opts.reps

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(opts.trace_reps):
                call()
            torch.cuda.synchronize()
    n = opts.trace_reps
    rows = sorted(prof.key_averages(), key=_device_us, reverse=True)
    device_ms = sum(_device_us(e) for e in rows) / n / 1e3
    kernels = sum(e.count for e in rows if _device_us(e) > 0) / n
    k10 = sum(_device_us(e) for e in rows if "vit_attn" in e.key) / n / 1e3
    median = statistics.median(wall)
    print(f"batch {opts.batch} ({5 * opts.batch} crops): wall ms "
          f"{', '.join(f'{w:.2f}' for w in wall)}; median {median:.2f}")
    print(f"tower-attention wrapper: {k10_calls:.0f} calls a call, host "
          f"{statistics.median(wrapper_ms):.2f} ms a call (median)")
    print(f"device (torch.profiler, {n} calls): {device_ms:.3f} ms a call, "
          f"{kernels:.0f} kernels a call, tower attention {k10:.3f} ms; "
          f"idle {1 - device_ms / median:.1%} of the median wall time")
    for e in rows[:10]:
        print(f"  {_device_us(e) / n / 1e3:8.3f} ms {e.count // n:5d}x  "
              f"{e.key[:90]}")
    print(json.dumps({
        "tree": str(tree), "card": card, "batch": opts.batch,
        "wall_ms": wall, "wall_ms_median": median,
        "wrapper_host_ms_median": statistics.median(wrapper_ms),
        "wrapper_calls": k10_calls, "device_ms": device_ms,
        "kernels": kernels, "vit_attention_device_ms": k10,
        "idle_share": 1 - device_ms / median,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
