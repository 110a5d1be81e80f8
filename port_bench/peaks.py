"""The card's published peaks and the least time a piece of work needs.

NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the 700 W limit):
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM. A product's
work is counted at the sizes the model states: every input byte read
once, every output byte written once, an int4 weight at its true input
dim (not the zero rows its layout pads it to)."""

from __future__ import annotations

from port_bench.reference.int4 import geometry

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def int4_product(M: int, K: int, N: int) -> tuple[float, float]:
    """(FLOPs, bytes) of x [M, K] bf16 times an int4 weight [K, N]: the
    activations, the packed codes, the float32 group scales and the bf16
    output."""
    group = geometry(K)[1]
    return (2.0 * M * K * N,
            2.0 * M * K + K * N / 2 + -(-K // group) * N * 4.0
            + 2.0 * M * N)


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card needs, and which bound sets it."""
    by_ops, by_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (by_ops, "flops") if by_ops >= by_bytes else (by_bytes, "bytes")


def int4_route_seconds(linears, M: int, calls: int = 1) -> float:
    """The least time of ``calls`` passes over ``linears`` ((K, N, count)
    triples) at M rows. At M <= 32 the bytes bound it, at the prefill's M
    the FLOPs."""
    return sum(least_seconds(*int4_product(M, K, N))[0] * count * calls
               for K, N, count in linears)
