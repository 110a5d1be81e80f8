"""The plain reference against the port's plain path, on tiny
configurations of both families in float32 on the CPU: the same seed's
weights, the port's int4 made by its quantizer, the reference's worked
out by itself; the port's training forward (every text position's
logits) against the reference's logits at the same positions."""

import copy

import pytest
import torch
from conftest import TINY_7B, TINY_FALCON

from port_bench.program import falcon as falcon_program
from port_bench.program import internlm2_ens5 as il_program
from port_bench.reference import falcon as falcon_ref
from port_bench.reference import internlm2_ens5 as il_ref
from port_bench.traffic.make import render


def f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["dtype"] = "float32"
    return cfg


def close(got, want):
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) < 1e-5, float(err)


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_internlm2_reference_matches_port(seed):
    from a3vlm_tpu_torch.models import internlm_ems5_light as il

    cfg = f32(TINY_7B)
    model = il_program.build(cfg, seed, "cpu")
    t = cfg["towers"]
    image = render(seed, 0, t["image_size"], t["input_mean"], t["input_std"],
                   "cpu", torch.float32)
    ids = [1, 7, 9, 200, 31, 4, 55, 90, 12, 3]
    with torch.inference_mode():
        port = il.forward(model.params, model.cfg, torch.tensor([ids]),
                          image=image[None], impl="plain")[0]
    ref = il_ref.served_logits(cfg, seed, [{"prompt": ids[:4],
                                            "served": ids[4:],
                                            "image": 0}], {0: image}, "cpu")[0]
    close(port[3:-1], ref)


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_falcon_reference_matches_port(seed):
    from a3vlm_tpu_torch.models import falcon as fm

    cfg = f32(TINY_FALCON)
    model = falcon_program.build(cfg, seed, "cpu")
    ids = [17, 99, 23, 250, 12, 13, 14, 77, 81]
    with torch.inference_mode():
        port = fm.forward_train(model.params, model.args,
                                torch.tensor([ids]), impl="plain")[0]
    ref = falcon_ref.served_logits(cfg, seed, [{"prompt": ids[:3],
                                                "served": ids[3:],
                                                "image": None}], {}, "cpu")[0]
    close(port[2:-1], ref)
