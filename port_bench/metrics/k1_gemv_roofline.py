"""K1's GEMV route (``gemv_cluster_kernel<0, ...>``, the exact int4
kernel at M <= 32) in the traced batch: the least time its work needs at
the card's peaks over its device time, in %. The work: every int4 linear
of the decoder and the head at M = the batch's rows, once a decode step,
and the head once more after the prefill."""

from port_bench.peaks import int4_route_seconds
from port_bench.trace import route_seconds


def read(run):
    t = run["traced"]
    if t is None:
        return None
    spent, launches = route_seconds(t["trace"], "gemv_cluster_kernel<0")
    if not launches:
        return None
    linears = run["arch"].int4_linears(run["cfg"])
    need = int4_route_seconds(linears, t["rows"], t["decode_steps"])
    head = int4_route_seconds(linears[-1:], t["rows"])
    return 100.0 * (need + head) / spent
