"""The one traffic generator: static batches of token-id requests (and
images) from a mix's parameters (``traffic/<mix>.json``) and the run's
seed.

A batch's prompt lengths are drawn from the mix's bands, each request's
band by its share and its length uniform inside the band, from a stream
of the batch's index alone: every seed runs the same lengths batch by
batch, so the seed changes the ids, the images and the order of the
rows, never the work.

Keys of a mix: ``batch`` (requests a batch), ``prompt_len`` (bands
``[shortest, longest, share]`` in ids, BOS included; the shares sum to
1), ``new_ids`` (the program's ``max_gen_len``: a row with a shorter
prompt produces more), ``bos`` (the id every prompt starts with, or
null), ``shared_prefix`` (ids after BOS that every request of a run
shares: a template or a system prompt), ``first_id`` (ids are drawn from
[first_id, vocab)), and ``images`` (null, or ``size`` in pixels and
``questions_per_render``: consecutive requests ask that many questions
of one render, each sending the image again). Other keys (``source``,
``assumed``) say where the numbers come from; the generator reads none
of them."""

from __future__ import annotations

import torch

from port_bench.seeding import generator

KEYS = {"batch", "prompt_len", "new_ids", "bos", "shared_prefix",
        "first_id", "images"}


def draw_lengths(bands, n: int, b: int) -> list:
    """Batch ``b``'s ``n`` prompt lengths from ``bands``; no run seed."""
    g = generator("cpu", 0, "lengths", b)
    shares = torch.tensor([s for _, _, s in bands], dtype=torch.float64)
    picks = torch.multinomial(shares, n, replacement=True, generator=g)
    return [int(torch.randint(bands[k][0], bands[k][1] + 1, (1,),
                              generator=g)) for k in picks.tolist()]


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        missing = KEYS - set(mix)
        if missing:
            raise ValueError(f"traffic mix lacks {sorted(missing)}")
        bands = mix["prompt_len"]
        head = (mix["bos"] is not None) + mix["shared_prefix"]
        if (not bands or any(not head < lo <= hi or s <= 0
                             for lo, hi, s in bands)
                or abs(sum(s for _, _, s in bands) - 1) > 1e-9
                or mix["first_id"] >= vocab):
            raise ValueError(f"traffic mix {mix} does not fit vocab {vocab}")
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self._prefix = ([] if mix["bos"] is None else [mix["bos"]]) + \
            self._ids(mix["shared_prefix"], "prefix")

    def _ids(self, n: int, *tag) -> list:
        g = generator("cpu", self.seed, *tag)
        return torch.randint(self.mix["first_id"], self.vocab, (n,),
                             generator=g).tolist()

    @property
    def new_ids(self) -> int:
        return self.mix["new_ids"]

    def batch(self, b: int) -> dict:
        """Batch ``b``: ``prompts`` (lists of ids) and ``renders`` (the
        render each request asks about, or None)."""
        B = self.mix["batch"]
        lengths = draw_lengths(self.mix["prompt_len"], B, b)
        order = torch.randperm(B, generator=generator("cpu", self.seed,
                                                      "order", b)).tolist()
        prompts = []
        for j, k in enumerate(order):
            n = lengths[k] - len(self._prefix)
            prompts.append(self._prefix + self._ids(n, "ids", b, j))
        renders = None
        if self.mix["images"]:
            q = self.mix["images"]["questions_per_render"]
            renders = [(b * B + j) // q for j in range(B)]
        return {"prompts": prompts, "renders": renders}


def render(seed: int, key: int, size: int, mean, std, device,
           dtype: torch.dtype) -> torch.Tensor:
    """Render ``key`` of a run: [size, size, 3] uniform pixels from its own
    stream, normalised by the model's ``mean`` and ``std``."""
    g = generator(device, seed, "render", key)
    pixels = torch.rand(size, size, 3, generator=g, device=device)
    m = torch.tensor(mean, device=device)
    s = torch.tensor(std, device=device)
    return ((pixels - m) / s).to(dtype)
