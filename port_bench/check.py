"""The comparison that decides ``correct``: once the window has closed
and the program is freed, a sample of the requests it finished, drawn
from the seed with the one that served the most ids always in it, goes
through the plain float32 reference (towers, prefill and every position
the decode steps produced, as one forward pass over prompt and served
ids). For every served id, greedy by construction, the gap is how far
its reference logit lies below the reference's best one. The numbers
worked out (the cell's file names those compared, each with its limit;
the others are printed only):

- ``widest_gap``: the largest gap;
- ``mean_gap``: the mean gap over the served ids;
- ``widest_excess``: the largest part of a gap beyond one bf16 step at
  the reference's best logit. The program's logits leave the head in
  bf16, as the configuration states, so two logits that far apart can
  round to one value and the program then serves either; only the
  excess is an error of the computation;
- ``mean_excess``: the mean of that excess over the served ids;
- ``over_step_share``: the share of served ids whose gap exceeds that
  step.

A request whose row came back malformed (the wrong number of ids, or an
id outside the vocabulary) counts as failed."""

from __future__ import annotations

import torch

from port_bench.seeding import generator


def malformed(prompts, outs, new_ids: int, vocab: int) -> int:
    """Rows that did not return what they must: the program runs every
    row to the longest prompt plus ``new_ids``, ids inside the vocab."""
    total = max(len(p) for p in prompts) + new_ids
    return sum(len(o) != total - len(p) or any(not 0 <= t < vocab
                                               for t in o)
               for p, o in zip(prompts, outs))


def sample(requests: list, k: int, seed: int) -> list:
    """``k`` of ``requests`` (dicts with ``served``): the one that served
    the most ids (the first such), then others drawn from the seed."""
    if not requests:
        return []
    longest = max(range(len(requests)),
                  key=lambda i: (len(requests[i]["served"]), -i))
    rest = [i for i in range(len(requests)) if i != longest]
    order = torch.randperm(len(rest), generator=generator("cpu", seed,
                                                          "sample")).tolist()
    return [requests[longest]] + [requests[rest[j]]
                                  for j in order[:max(k - 1, 0)]]


def gaps(logits: list, requests: list) -> tuple:
    """(every served id's gap below the reference's best logit, that best
    logit)."""
    gap, best = [], []
    for lg, r in zip(logits, requests):
        served = torch.tensor(r["served"], device=lg.device)
        top = lg.max(-1).values
        gap.append(top - lg.gather(1, served[:, None]).squeeze(1))
        best.append(top)
    return torch.cat(gap).double().cpu(), torch.cat(best).double().cpu()


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def numbers(gap: torch.Tensor, best: torch.Tensor) -> dict:
    excess = (gap - bf16_step(best)).clamp_min(0)
    return {"widest_gap": float(gap.max()), "mean_gap": float(gap.mean()),
            "widest_excess": float(excess.max()),
            "mean_excess": float(excess.mean()),
            "over_step_share": float((excess > 0).double().mean())}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": found[k], "limit": limits[k]} for k in limits}
    return all(found[k] <= limits[k] for k in limits), shown
