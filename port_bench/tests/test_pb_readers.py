"""Each metric reader on a fixed record."""

import pytest
from conftest import ROOT, TINY_FALCON

from port_bench import core
from port_bench.arch import falcon
from port_bench.peaks import PEAK_FLOPS, int4_route_seconds

BATCH = {"rows": 4, "seconds": 2.0, "gen_ids": 30, "prompt_lens": [9, 17],
         "gen_lens": [14, 6], "images_sent": 4, "distinct_images": 2,
         "bucket": 8, "image_words": 95, "towers_ms": 40.0,
         "prefill_ms": 20.0, "decode_ms": 300.0, "decode_steps": 15}
TRACE = {"busy_s": 0.75, "window_s": 1.0, "events": 9,
         "kernels": {"gemv_cluster_kernel<0, 4>": [0.01, 31],
                     "int4_mma_kernel<0>": [0.02, 12],
                     "elementwise": [0.5, 100]},
         "gaps": {}}


def run(**kw):
    rec = dict(BATCH)
    traced = dict(rec, trace=TRACE)
    out = {"cfg": TINY_FALCON, "arch": falcon,
           "batches": [rec, dict(rec, seconds=3.0)], "traced": traced,
           "setup_s": 12.5, "peak_bytes": 3 * 2 ** 30}
    out.update(kw)
    return out


def read(name, r):
    return core.find_reader(ROOT, name)(r)


def test_end_to_end_readers():
    r = run()
    assert read("answers_per_s", r) == pytest.approx(8 / 5.0)
    assert read("setup_s", r) == 12.5


def test_span_readers():
    r = run()
    assert read("towers_ms_per_image", r) == pytest.approx(80 / 8)
    assert read("prefill_us_per_token.ans", r) == pytest.approx(
        1e3 * 40 / (2 * 4 * (8 + 95)))
    assert read("decode_step_ms.tok", r) == pytest.approx(600 / 30)
    assert read("peak_gib.ans", r) == 3.0
    no_images = run(batches=[dict(BATCH, images_sent=0)])
    assert read("towers_ms_per_image", no_images) is None


def test_trace_readers():
    r = run()
    assert read("device_idle_share.ans", r) == pytest.approx(25.0)
    lin = falcon.int4_linears(TINY_FALCON)
    gemv = (int4_route_seconds(lin, 4, 15)
            + int4_route_seconds(lin[-1:], 4))
    assert read("k1_gemv_roofline.tok", r) == pytest.approx(
        100 * gemv / 0.01)
    tile = int4_route_seconds(lin[:-1], 4 * (8 + 95))
    assert read("k1_tile_roofline.ans", r) == pytest.approx(
        100 * tile / 0.02)
    untraced = run(traced=None)
    for name in ("device_idle_share.ans", "k1_gemv_roofline.tok",
                 "k1_tile_roofline.ans"):
        assert read(name, untraced) is None


def test_roofline_silent_without_its_kernels():
    r = run()
    r["traced"] = dict(r["traced"], trace=dict(TRACE, kernels={
        "elementwise": [0.5, 100]}))
    assert read("k1_gemv_roofline.ans", r) is None
    assert read("k1_tile_roofline.tok", r) is None


def test_mfu_reader():
    r = run()
    flops = 2 * falcon.batch_flops(TINY_FALCON, [9, 17], [14, 6])
    assert read("mfu.tok", r) == pytest.approx(
        100 * flops / (5.0 * PEAK_FLOPS))


def test_unknown_metric_has_no_reader():
    with pytest.raises(FileNotFoundError):
        core.find_reader(ROOT, "no_such_metric.ans")
