"""The traffic generator: seeded ids, every length inside a band of its
mix, the same lengths batch by batch for every seed."""

import json

import pytest
import torch
from conftest import ROOT, TINY_MIXES

from port_bench.traffic.make import Traffic, draw_lengths, render

VOCAB = {"eval-rec2d": 92544, "tiny-eval": 256, "tiny-chat": 256}


def mix(name):
    if name in TINY_MIXES:
        return dict(TINY_MIXES[name])
    with open(ROOT / "port_bench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", VOCAB)
def test_same_seed_same_batches(name):
    a = Traffic(mix(name), 2 ** 31 + 77, VOCAB[name])
    b = Traffic(mix(name), 2 ** 31 + 77, VOCAB[name])
    c = Traffic(mix(name), 2 ** 31 + 78, VOCAB[name])
    assert a.batch(3) == b.batch(3)
    assert a.batch(0)["prompts"] != c.batch(0)["prompts"]


@pytest.mark.parametrize("name", VOCAB)
def test_lengths_in_bands_and_same_work_every_seed(name):
    m = mix(name)
    bands = m["prompt_len"]
    seen = {}
    for seed in (1, 2 ** 32 + 5):
        t = Traffic(m, seed, VOCAB[name])
        for b in range(3):
            batch = t.batch(b)
            lens = [len(p) for p in batch["prompts"]]
            assert len(lens) == m["batch"]
            assert all(any(lo <= n <= hi for lo, hi, _ in bands)
                       for n in lens)
            assert all(m["first_id"] <= i < VOCAB[name]
                       for p in batch["prompts"] for i in p[1:])
            assert sorted(lens) == seen.setdefault(b, sorted(lens))


def test_draws_follow_the_shares():
    bands = mix("eval-rec2d")["prompt_len"]
    lens = [n for b in range(40) for n in draw_lengths(bands, 32, b)]
    for lo, hi, share in bands:
        inside = [n for n in lens if lo <= n <= hi]
        assert abs(len(inside) / len(lens) - share) < 0.05
        assert set(inside) == set(range(lo, hi + 1))
    assert len({tuple(draw_lengths(bands, 32, b)) for b in range(5)}) == 5


def test_shared_prefix_and_renders():
    m = mix("eval-rec2d")
    t = Traffic(m, 9, VOCAB["eval-rec2d"])
    head = 1 + m["shared_prefix"]
    b0, b1 = t.batch(0), t.batch(1)
    prefixes = {tuple(p[:head]) for p in b0["prompts"] + b1["prompts"]}
    assert len(prefixes) == 1 and next(iter(prefixes))[0] == m["bos"]
    q = m["images"]["questions_per_render"]
    assert b0["renders"] == [j // q for j in range(m["batch"])]
    assert b1["renders"][0] == m["batch"] // q


def test_render_is_seeded():
    a = render(5, 2, 32, (0.5, 0.5, 0.5), (0.25, 0.25, 0.25), "cpu",
               torch.bfloat16)
    b = render(5, 2, 32, (0.5, 0.5, 0.5), (0.25, 0.25, 0.25), "cpu",
               torch.bfloat16)
    c = render(5, 3, 32, (0.5, 0.5, 0.5), (0.25, 0.25, 0.25), "cpu",
               torch.bfloat16)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (32, 32, 3) and float(a.float().abs().max()) <= 2.0


@pytest.mark.parametrize("change", [
    lambda m: m.pop("new_ids"),
    lambda m: m.update(prompt_len=[[8, 9, 0.5], [11, 12, 0.4]]),
    lambda m: m.update(prompt_len=[[2, 9, 1.0]]),
])
def test_bad_mix_refused(change):
    m = mix("tiny-eval")
    change(m)
    with pytest.raises(ValueError):
        Traffic(m, 1, 256)
