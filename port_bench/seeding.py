"""Seeds and seeded draws shared by the traffic, the weights and the
reference. Nothing here imports the program under test."""

from __future__ import annotations

import hashlib
import math

import torch


def mix(seed: int, *parts) -> int:
    """A 63-bit seed for one stream (a layer, a batch, a render) of a run's
    ``seed``: the same parts give the same number on every machine."""
    text = repr((int(seed),) + tuple(parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *parts))


def fill(specs, gen: torch.Generator, device, dtype) -> list:
    """One ``randn`` call for every leaf of ``specs`` (``(shape, std)``
    pairs): contiguous views of one buffer, each scaled in place by its
    std. The buffer lives as long as a view does."""
    sizes = [math.prod(shape) for shape, _ in specs]
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, off = [], 0
    for (shape, std), n in zip(specs, sizes):
        out.append(buf[off:off + n].view(shape).mul_(std))
        off += n
    return out


OUTLIER_SHARE = 128
OUTLIER_GAIN = 8.0


def norm_gains(n: int, seed: int, tag, device, dtype, lead=()) -> torch.Tensor:
    """A norm's weight: 1, but ``OUTLIER_GAIN`` on one channel in
    ``OUTLIER_SHARE`` (at least one), the same channels for every norm of
    ``tag``: the outlier features of trained transformers, which set the
    range that a per-row int8 rounding of the norm's output spreads over."""
    g = torch.ones(*lead, n, dtype=dtype, device=device)
    k = max(1, n // OUTLIER_SHARE)
    idx = torch.randperm(n, generator=generator("cpu", seed, "outliers",
                                                tag, n))[:k]
    g[..., idx.to(device)] = OUTLIER_GAIN
    return g
