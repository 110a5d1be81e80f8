"""The rest of a run without the card's look, on the CPU at a tiny size,
with the timed path broken underneath: a sound run comes out correct,
and each fault a serving cell can have makes ``correct`` false. (The
exchange between cards is a fault only a cell on several cards has.)"""

import time

import pytest

from port_bench import core


def run(root, cell, seed=7):
    return core.run_cell(root, cell, seed, 0.0, False, "cpu",
                         time.perf_counter())[0]


@pytest.mark.parametrize("cell", ["tiny-7b", "tiny-falcon"])
def test_sound_run_is_correct(tiny_root, cell):
    out = run(tiny_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 4


def _cache_unchanged(monkeypatch):
    """The decode step attends but never writes its state (the cache)."""
    from a3vlm_tpu_torch.models import falcon, llama

    for mod in (llama, falcon):
        orig = mod.update_and_attend_decode_cache

        def frozen(xq, ck, cv, *a, _orig=orig, **k):
            return _orig(xq, ck.clone(), cv.clone(), *a, **k)

        monkeypatch.setattr(mod, "update_and_attend_decode_cache", frozen)


def _wrap_generate(monkeypatch, change):
    from a3vlm_tpu_torch.meta import MetaModel

    orig = MetaModel.generate_tokens

    def wrapped(self, prompts, images=None, **kw):
        return change(orig, self, prompts, images, kw)

    monkeypatch.setattr(MetaModel, "generate_tokens", wrapped)


def _half_batch(monkeypatch):
    """Only the first half of the batch computed, its rows given twice."""
    def change(orig, self, prompts, images, kw):
        h = len(prompts) // 2
        out = orig(self, prompts[:h],
                   images=None if images is None else images[:h], **kw)
        return out + out[: len(prompts) - h]

    _wrap_generate(monkeypatch, change)


def _token_altered(monkeypatch):
    """Each row's first generated id altered where it is produced."""
    def change(orig, self, prompts, images, kw):
        out = orig(self, prompts, images=images, **kw)
        return [[(o[0] + 1) % self.true_vocab] + o[1:] for o in out]

    _wrap_generate(monkeypatch, change)


def _towers_skipped(monkeypatch):
    """The towers' image words replaced by zeros."""
    import torch

    from a3vlm_tpu_torch.models import internlm_ems5_light as il

    orig = il.build_image_tokens
    monkeypatch.setattr(il, "build_image_tokens",
                        lambda *a, **k: torch.zeros_like(orig(*a, **k)))


FAULTS = {"cache_unchanged": _cache_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("cell", ["tiny-7b", "tiny-falcon"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    assert not run(tiny_root, cell)["correct"]


def test_towers_skipped_is_not_correct(tiny_root, monkeypatch):
    _towers_skipped(monkeypatch)
    assert not run(tiny_root, "tiny-7b")["correct"]
