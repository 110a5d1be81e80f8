"""Prompt-lookup speculative decoding, batch 1 (counterpart of
a3vlm_tpu/lookup_decode.py).

A speculative decoder that needs no draft model, for the image->triad
latency path: triad answers are highly structured (repeated ``<rb>`` and
``<axis>`` tags, fixed-format number lists, phrases copied from the
instruction), so the NEXT tokens often already follow an earlier occurrence
of the current n-gram. Each round:

1. finds the most recent earlier occurrence of the longest suffix n-gram
   (n up to ``max_n``) in [prompt + generated so far],
2. takes the K-1 tokens that followed it as a DRAFT,
3. runs ONE K-token verify forward through the decode cache (batch-1 decode
   is bound by reading the weights, and a K-token step reads the same
   weight bytes as a 1-token step),
4. accepts the longest matching prefix and emits ``accepted + 1`` tokens:
   the output is EXACTLY what one-token-at-a-time decoding gives.

Cache discipline: the verify step writes all K rows at [pos, pos+K);
rejected rows hold garbage, but the next window [pos+m, pos+m+K) rewrites
them before they can be attended.

The JAX version is one ``while_loop`` under jit. Here the loop runs on the
host: the verify forward, the masks and the token choice are device
tensors; the draft lookup, the DFA walk and the acceptance count, a few
integers per round, run on the host from the K predicted ids, which is the
one transfer a round makes."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from a3vlm_tpu_torch.models import llama
from a3vlm_tpu_torch.ops.norms import rms_norm
from a3vlm_tpu_torch.ops.sampling import sample_token
from a3vlm_tpu_torch.parallel import tp


def _verify_step(params, args, cache, tokens_k: torch.Tensor, pos: int,
                 impl: str = "auto"):
    """Run K draft tokens [K] through the decode cache at absolute positions
    [pos, pos+K) (lookup_decode.py:38): all K rows are written, and token i
    attends rows <= pos + i. Returns (logits [K, V] float32, cache)."""
    K = tokens_k.shape[-1]
    device = tokens_k.device
    h = llama.embed_tokens(params, tokens_k[None])  # [1, K, D]
    positions = pos + torch.arange(K, device=device)
    h, cache = llama.forward_hidden(
        params, args, h, positions, "causal", cache=cache, write_pos=pos,
        kv_valid_len=torch.full((1,), pos + K, dtype=torch.int32,
                                device=device),
        impl=impl,
    )
    h = rms_norm(h, params["norm"]["weight"], args.norm_eps)
    logits = tp.head(h[0], params["output"]["weight"], impl).float()
    return logits, cache


def find_draft(buf: np.ndarray, n_buf: int, K: int, max_n: int = 4):
    """Longest-suffix n-gram lookup (n = max_n .. 1) over ``buf[:n_buf]``:
    the most recent i with buf[i : i+n] == buf[n_buf-n : n_buf] and
    i + n < n_buf; the draft is buf[i+n : i+n+K-1], read from the whole
    buffer (entries past n_buf are what earlier rounds left there, as in
    the JAX loop). A longer matched context disambiguates repeats. With no
    match at any n the draft repeats the last token."""
    idx = np.arange(buf.shape[0])
    prev = np.ones(buf.shape[0], bool)
    cont_start = -1
    for m in range(1, max_n + 1):
        cmp = buf == buf[max(n_buf - m, 0)]
        prev = cmp & (np.roll(prev, -1) if m > 1 else True)
        hit = prev & (idx + m < n_buf)
        if hit.any():
            cont_start = int(idx[hit].max()) + m
    if cont_start < 0:
        return np.full(K - 1, buf[n_buf - 1], buf.dtype)
    return buf[cont_start:cont_start + K - 1].copy()


@torch.inference_mode()
def lookup_generate(
    params,
    args,
    cache,
    prompt_ids: Sequence[int],  # text ids only; the cache is prefilled
    start_pos: int,  # absolute position of the NEXT token (P + W)
    first_token: int,  # the token chosen after prefill
    gen_len: int,
    draft_k: int = 8,
    vocab_limit: Optional[int] = None,
    stop_token: int = -1,
    fsm_next: Optional[torch.Tensor] = None,  # [S, V] int32 grammar table
    fsm_state0: int = 0,  # DFA state AFTER first_token
    temperature: float = 0.0,
    top_p: float = 0.95,
    sample_uniforms: Optional[torch.Tensor] = None,  # [>= gen_len + draft_k]
    accept_cap: Optional[Sequence[int]] = None,
    max_n: int = 4,
    impl: str = "auto",
    fsm_host: Optional[np.ndarray] = None,  # fsm_next on the host
):
    """Speculative generation (lookup_decode.py:68). Returns
    (tokens [gen_len] int64 on the host, count, rounds):
    ``tokens[:count]`` equals what one-token-at-a-time decoding would give
    (stopping at ``stop_token`` if emitted); ``rounds`` is the number of
    verify forwards.

    SAMPLING (``temperature > 0``): verify position ``i`` of a window that
    starts with ``n_emit`` tokens already emitted is sampled with
    ``sample_uniforms[n_emit + i]``. The caller passes the uniforms the
    one-token loop would use, index for index, so for one seed the output
    equals that loop's: each position's logits condition on the draft
    prefix, which equals the emitted prefix wherever the token counts as
    accepted. Acceptance compares the SAMPLED token with the draft.

    With ``fsm_next`` set the guarantee is against grammar-CONSTRAINED
    decoding: each verify position's logits are masked by the DFA state
    walked along the draft prefix, and draft tokens that would kill the DFA
    are repaired to the first legal token before verification (repair only
    changes PROPOSALS, so exactness is unaffected; it keeps the later
    positions' states, and thus their masks, meaningful).

    CACHE SIZING: the last verify window can write up to ``draft_k`` rows
    past the last emitted position; size the cache with
    ``start_pos + gen_len + draft_k + 1`` rows.

    ``accept_cap`` (for benchmarks): per-round caps on the accepted draft
    length, cycled by round index. Accepting FEWER tokens than matched is
    always legal, so the output is unchanged; the loop only spends the
    rounds a given acceptance would."""
    device = params["norm"]["weight"].device
    P = len(prompt_ids)
    K = draft_k
    buf = np.zeros(P + gen_len + K + 2, np.int64)
    buf[:P] = np.asarray(prompt_ids, np.int64)
    buf[P] = first_token
    use_fsm = fsm_next is not None
    if use_fsm and fsm_host is None:
        fsm_host = fsm_next.cpu().numpy()
    V = args.vocab_size
    pad_mask = None
    if vocab_limit is not None and vocab_limit < V:
        pad_mask = torch.arange(V, device=device) >= vocab_limit

    n_emit, pos, rounds = 1, int(start_pos), 0
    done = int(first_token) == stop_token
    fstate = int(fsm_state0)
    while not done and n_emit < gen_len:
        n_buf = P + n_emit
        draft = find_draft(buf, n_buf, K, max_n)
        states = None
        if use_fsm:
            # walk the DFA along the draft, repairing illegal tokens to the
            # first legal one (every live state has one); states[i] is the
            # state before position i's prediction
            states = [fstate]
            s = fstate
            for j in range(K - 1):
                if fsm_host[s, draft[j]] < 0:
                    draft[j] = int(np.argmax(fsm_host[s] >= 0))
                s = int(fsm_host[s, draft[j]])
                states.append(s)
        tokens_k = np.concatenate([buf[n_buf - 1:n_buf], draft])  # [K]
        logits, cache = _verify_step(
            params, args, cache, torch.from_numpy(tokens_k).to(device), pos,
            impl)
        # -1e30, not -inf, as the one-token loop masks
        if pad_mask is not None:
            logits = logits.masked_fill(pad_mask, -1e30)
        if use_fsm:
            rows = fsm_next[torch.tensor(states, device=device)]
            logits = torch.where(rows >= 0, logits,
                                 torch.full_like(logits, -1e30))
        if temperature > 0.0:
            u = sample_uniforms[n_emit:n_emit + K]
            preds = sample_token(logits, temperature, top_p, uniform=u)
        else:
            preds = torch.argmax(logits, dim=-1)
        preds = preds.cpu().numpy().astype(np.int64)

        # accepted: draft token i+1 matched pred i, and all before it
        match = preds[:K - 1] == draft
        accepted = int(np.cumprod(match).sum())
        if accept_cap is not None:
            accepted = min(accepted, int(accept_cap[rounds % len(accept_cap)]))
        m = min(accepted + 1, gen_len - n_emit)
        # emit up to and including the first stop token
        stops = np.nonzero(preds == stop_token)[0]
        first_stop = int(stops[0]) if stops.size else K
        m = min(m, first_stop + 1)
        done = first_stop < m
        if use_fsm:
            # DFA state after the LAST emitted token: accepted positions land
            # back on the draft walk, only the last can leave it
            fstate = max(int(fsm_host[states[m - 1], preds[m - 1]]), 0)
        buf[n_buf:n_buf + K] = preds  # all K written, only m count
        n_emit += m
        pos += m
        rounds += 1
    return buf[P:P + gen_len].copy(), n_emit, rounds


@torch.inference_mode()
def greedy_reference(params, args, cache, start_pos, first_token, gen_len,
                     vocab_limit=None, stop_token=-1, fsm_next=None,
                     fsm_state0=0, impl: str = "auto"):
    """One-token-at-a-time greedy loop (lookup_decode.py:264), the oracle
    for tests; with ``fsm_next`` (a numpy table) the grammar-constrained
    greedy oracle."""
    device = params["norm"]["weight"].device
    out = [int(first_token)]
    pos, t, fstate = int(start_pos), int(first_token), int(fsm_state0)
    while len(out) < gen_len and t != stop_token:
        logits, cache = llama.decode_step(
            params, args, cache, torch.tensor([[t]], device=device), pos,
            impl)
        lg = logits[0].cpu().numpy()
        if vocab_limit is not None:
            lg = lg[:vocab_limit]
        if fsm_next is not None:
            lg = np.where(fsm_next[fstate, :lg.shape[-1]] >= 0, lg, -np.inf)
        t = int(np.argmax(lg))
        if fsm_next is not None:
            fstate = max(int(fsm_next[fstate, t]), 0)
        out.append(t)
        pos += 1
    return out
