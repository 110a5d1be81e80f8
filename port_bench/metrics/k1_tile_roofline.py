"""K1's tiled route (``int4_mma_kernel<0>``, the exact int4 kernel at
M > 32) in the traced batch: the least time its work needs at the card's
peaks over its device time, in %. The work: every int4 linear of the
decoder's layers at M = rows x (the prefill bucket + the image words),
once (the prefill)."""

from port_bench.peaks import int4_route_seconds
from port_bench.trace import route_seconds


def read(run):
    t = run["traced"]
    if t is None:
        return None
    spent, launches = route_seconds(t["trace"], "int4_mma_kernel<0")
    if not launches:
        return None
    linears = run["arch"].int4_linears(run["cfg"])[:-1]
    need = int4_route_seconds(
        linears, t["rows"] * (t["bucket"] + t["image_words"]))
    return 100.0 * need / spent
