"""The work functions behind the rooflines and the MFU, against hand
counts."""

import pytest

from port_bench.arch import falcon, internlm2_ens5
from port_bench.peaks import (
    PEAK_BYTES,
    PEAK_FLOPS,
    int4_product,
    int4_route_seconds,
    least_seconds,
)
from port_bench.reference.int4 import geometry
from conftest import TINY_7B, TINY_FALCON


def test_int4_product_decode_shape():
    # x [4, 4096] bf16, codes 4096 x 1024 / 2 bytes, 64 groups of float32
    # scales a column, out [4, 1024] bf16
    flops, nbytes = int4_product(4, 4096, 1024)
    assert flops == 2 * 4 * 4096 * 1024 == 33554432
    assert nbytes == 32768 + 2097152 + 262144 + 8192
    s, by = least_seconds(flops, nbytes)
    assert by == "bytes" and s == pytest.approx(2400256 / 3.35e12)


def test_int4_product_prefill_shape_at_true_k():
    # Falcon's MLP up at M = 2048: K = 14848 counted as such (its layout
    # pads it to 16384), 232 groups of 64
    flops, nbytes = int4_product(2048, 14848, 59392)
    assert flops == 3612067495936
    assert nbytes == 800129024
    s, by = least_seconds(flops, nbytes)
    assert by == "flops" and s == pytest.approx(3612067495936 / 989e12)


def test_route_seconds_sums_counts():
    lin = [(4096, 1024, 3), (14848, 59392, 2)]
    total = int4_route_seconds(lin, 2048, calls=5)
    one = [least_seconds(*int4_product(2048, K, N))[0] for K, N, _ in lin]
    assert total == pytest.approx(5 * (3 * one[0] + 2 * one[1]))
    assert PEAK_FLOPS == 989e12 and PEAK_BYTES == 3.35e12


@pytest.mark.parametrize("K,pad,group", [(4096, 4096, 64), (14336, 14336, 64),
                                         (14848, 16384, 64),
                                         (59392, 61440, 64), (64, 64, 32),
                                         (192, 192, 32)])
def test_int4_geometry(K, pad, group):
    assert geometry(K) == (pad, group)


def test_falcon_batch_flops_hand_count():
    # tiny Falcon: a layer's linears 64x64, 64x32 twice, 64x64, 64x256,
    # 256x64 = 45056 weights, 2 layers; attention 4 * 2 * 4 * 16 a position
    # attended; head 2 * 64 * 256. Prompt 3, 2 generated: 4 tokens fed,
    # attending 1..4 positions; the head twice.
    got = falcon.batch_flops(TINY_FALCON, [3], [2])
    assert got == 4 * 2 * 90112 + 512 * 10 + 2 * 32768 == 791552


def test_internlm2_batch_flops_counts_a_render_once():
    one = internlm2_ens5.batch_flops(TINY_7B, [8, 8], [5, 5], 1)
    two = internlm2_ens5.batch_flops(TINY_7B, [8, 8], [5, 5], 2)
    d = internlm2_ens5.dims(TINY_7B)
    W = d["image_words"]
    lin2 = 2 * sum(K * N * n for K, N, n in
                   internlm2_ens5.int4_linears(TINY_7B)[:-1])
    att = 4 * d["L"] * d["H"] * d["hd"]
    prefix = (internlm2_ens5.towers_flops(TINY_7B) + (W + 1) * lin2
              + att * (W + 1) * (W + 2) // 2)
    assert two - one == pytest.approx(prefix)
    assert W == 5 * (4 + 1 + 2)


def test_prefill_length_from_the_step_counter():
    # the record works the prefill out from the program's step counter;
    # here against the program's own rule, on the CPU
    from a3vlm_tpu_torch.generation import _prefill_bucket

    from port_bench.program import falcon as program
    from port_bench.program.common import run_batch

    model = program.build(TINY_FALCON, 4, "cpu")
    for lens in ([9, 17, 12], [16, 16], [33, 40]):
        prompts = [[12 + (i % 200) for i in range(n)] for n in lens]
        _, _, stats = run_batch(model, prompts, None, 5)
        assert (max(lens) + 5 - 1 - stats["decode_steps"]
                == _prefill_bucket(min(lens)))
