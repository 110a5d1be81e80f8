"""Sampling ops for generation (counterpart of a3vlm_tpu/ops/sampling.py).

Randomness comes from a ``torch.Generator``; it cannot reproduce JAX's
bits, so sampled output agrees with the JAX package in distribution, and
greedy output token for token."""

from __future__ import annotations

import torch


def top_p_filter(probs: torch.Tensor, p: float):
    """Sort descending and keep tokens while the cumulative probability
    *excluding* the token is <= p, renormalized (sampling.py:9-21).
    Returns (filtered sorted probs [B, V], sort indices [B, V])."""
    probs_sort, sort_idx = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    cum = torch.cumsum(probs_sort, dim=-1)
    keep = (cum - probs_sort) <= p
    probs_sort = torch.where(keep, probs_sort, torch.zeros_like(probs_sort))
    probs_sort = probs_sort / probs_sort.sum(-1, keepdim=True)
    return probs_sort, sort_idx


def sample_top_p(probs: torch.Tensor, p: float,
                 generator: torch.Generator | None = None,
                 uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Top-p (nucleus) sampling: ``probs`` [B, V] -> [B] int32, by inverse
    CDF over the filtered distribution with one uniform draw per row
    (``uniform`` [B] in [0, 1), drawn from ``generator`` when not given)."""
    probs_sort, sort_idx = top_p_filter(probs, p)
    if uniform is None:
        uniform = torch.rand(probs.shape[0], generator=generator,
                             device=probs.device, dtype=torch.float32)
    cdf = torch.cumsum(probs_sort, dim=-1)
    u = (uniform.to(cdf.dtype) * cdf[:, -1]).unsqueeze(-1)
    choice = torch.searchsorted(cdf, u, right=True)
    # u * total can round up to total itself
    choice = choice.clamp_max(probs.shape[-1] - 1)
    return torch.gather(sort_idx, -1, choice)[:, 0].to(torch.int32)


def sample_token(logits: torch.Tensor, temperature: float, top_p: float,
                 generator: torch.Generator | None = None,
                 uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy when ``temperature <= 0`` (sampling.py:26), else top-p with
    one uniform per row (``uniform`` [B], else drawn from ``generator``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return sample_top_p(probs, top_p, generator, uniform)
