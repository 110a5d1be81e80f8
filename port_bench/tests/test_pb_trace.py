"""The trace's reduction: kernel names, the union of device intervals,
the idle gaps and the breakdown."""

import pytest

from port_bench.trace import breakdown, route_seconds, short_name, summarize


@pytest.mark.parametrize("raw,short", [
    ("void (anonymous namespace)::gemv_cluster_kernel<0, 4>(CUtensorMap, "
     "(anonymous namespace)::GvArgs)", "gemv_cluster_kernel<0, 4>"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<c10::BFloat16>, at::detail::Array<char*, 3> >(int, "
     "at::native::CUDAFunctor_add<c10::BFloat16>)",
     "vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::"
     "BFloat16>, at::detail::Array<c"),
    ("int4_mma_kernel<0>", "int4_mma_kernel<0>"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_short_name(raw, short):
    assert short_name(raw) == short


def test_union_gaps_and_routes():
    events = [("void gemv_cluster_kernel<0, 4>(int)", 0.0, 1.0),
              ("k2", 0.5, 2.0), ("k3", 1.2, 1.5), ("k4", 3.0, 4.0),
              ("void gemv_cluster_kernel<0, 4>(int)", 4.5, 5.0)]
    s = summarize(events, 6.0)
    assert s["busy_s"] == pytest.approx(3.5)
    assert s["gaps"] == pytest.approx({"k2 -> k4": 1.0,
                                       "k4 -> gemv_cluster_kernel<0, 4>": 0.5})
    assert route_seconds(s, "gemv_cluster_kernel<0") == (pytest.approx(1.5),
                                                         2)
    b = breakdown(s, top=2)
    assert [k for k, _ in b["device_ops"]] == ["gemv_cluster_kernel<0, 4>",
                                               "k2"]
    assert b["idle_gaps"][0] == ["k2 -> k4", pytest.approx(1.0)]
