"""Batched KV-cached generation (counterpart of a3vlm_tpu/generation.py).

Semantics of the JAX loop (generation.py:150-284), run as a host loop of
eager steps:

- prompts right-padded; a prefill of the first P tokens, P the largest
  power of two <= the shortest prompt (in one piece, or in
  ``prefill_chunk``-token pieces), then one decode step per position, where
  positions still inside a prompt take the prompt's token instead of the
  sampled one;
- greedy when temperature == 0 (argmax over the true vocab), top-p
  otherwise, from a table of uniforms drawn once from a ``torch.Generator``:
  the step at index t always uses row t;
- with ``fsm`` (a ``constrained.TokenFsm``) every generated token is masked
  to the answer grammar, one DFA state per row;
- multi-token stop sequences checked per row at every step, recording where
  the match began; EOS is always a stop;
- with images, cache positions of text tokens are offset by the image words;
- ``kv_cache_bits=8`` keeps the cache in int8 with per-row scales;
- ``draft_k > 0`` sends a batch-1 request through prompt-lookup speculative
  decoding (``lookup_decode``), whose output equals this loop's.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.lookup_decode import lookup_generate
from a3vlm_tpu_torch.models import llama
from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype
from a3vlm_tpu_torch.ops.sampling import sample_token


def _prefill_bucket(min_prompt: int) -> int:
    p = 1
    while p * 2 <= min_prompt:
        p *= 2
    return p


def synchronize(device: torch.device) -> None:
    """Wait for the device, so host clocks bracket its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Generator:
    """Host-side orchestration over one decoder (generation.py:390)."""

    def __init__(self, params: dict, args: ModelArgs, tokenizer=None,
                 image_words: int = 0, vocab_limit: Optional[int] = None,
                 kv_cache_bits: Optional[int] = None,
                 prefill_chunk: Optional[int] = None):
        if kv_cache_bits not in (None, 8):
            raise ValueError(f"kv_cache_bits {kv_cache_bits}: want None or 8")
        self.params = params
        self.args = args
        self.tokenizer = tokenizer
        self.image_words = image_words
        self.vocab_limit = vocab_limit
        # 8 -> int8 KV cache with per-row scales (half the cache bytes per
        # decode step; ops/decode_attention.QuantizedKV)
        self.kv_cache_bits = kv_cache_bits
        # chunked prefill: bounds activation temporaries for long prompts
        self.prefill_chunk = prefill_chunk
        # wall times of the last call's phases (ms), synchronized on CUDA
        self.last_stats: dict = {}
        # set by the lookup path (draft_k > 0): emitted tokens and verify
        # rounds of the LAST request
        self.last_spec_stats: Optional[dict] = None
        self._fsm_tables: tuple = (None, None, None)

    @property
    def device(self) -> torch.device:
        return self.params["norm"]["weight"].device

    def _fsm_next(self, fsm):
        """(device table, host table) [S, vocab_size] int32 of a
        ``TokenFsm``; the lane-padded vocab tail is never legal
        (generation.py:519-526). The last grammar's tables are kept."""
        if fsm is None:
            return None, None
        if self._fsm_tables[0] is not fsm:
            nxt = np.asarray(fsm.next_state)
            pad = self.args.vocab_size - nxt.shape[1]
            if pad < 0:
                raise ValueError(f"fsm table {nxt.shape} wider than the "
                                 f"logits ({self.args.vocab_size})")
            if pad:
                nxt = np.pad(nxt, ((0, 0), (0, pad)), constant_values=-1)
            host = np.ascontiguousarray(nxt, np.int32)
            self._fsm_tables = (fsm, torch.from_numpy(host).to(self.device),
                                host)
        return self._fsm_tables[1], self._fsm_tables[2]

    def _prefill(self, cache, tokens, image_tokens, impl):
        if self.prefill_chunk:
            return llama.prefill_chunked(self.params, self.args, cache,
                                         tokens, image_tokens,
                                         self.prefill_chunk, impl)
        return llama.prefill(self.params, self.args, cache, tokens,
                             image_tokens, impl)

    def _truncate(self, prompt_tokens, image_tokens, max_gen_len):
        """Left-truncated prompts and the text positions left for them."""
        max_seq_len = self.args.max_seq_len
        if image_tokens is not None:
            max_seq_len -= self.image_words
        return ([list(t)[-(max_seq_len - max_gen_len):]
                 for t in prompt_tokens], max_seq_len)

    @torch.inference_mode()
    def generate_tokens(
        self,
        prompt_tokens: Sequence[Sequence[int]],
        image_tokens: Optional[torch.Tensor] = None,
        max_gen_len: int = 512,
        temperature: float = 0.0,
        top_p: float = 0.95,
        stop_tokens: Sequence[Sequence[int]] = ((2,),),
        seed: int = 0,
        impl: str = "auto",
        fsm=None,
        draft_k: int = 0,
        lookup_max_n: int = 4,
    ) -> list[list[int]]:
        """Generate from token-id prompts (BOS included). Returns each row's
        generated ids, cut where the first stop sequence began.

        ``fsm``: a ``constrained.TokenFsm``; every generated token is masked
        to the answer grammar (EOS only in accepting states), greedy or
        top-p. ``draft_k``: a batch-1 request goes through prompt-lookup
        speculative decoding; the ids are exactly this loop's, with ``fsm``
        (constrained greedy) and with ``temperature > 0`` (the same uniform
        per emitted index, so the same output for the same seed). A batch
        of more than one request takes the vanilla loop."""
        args = self.args
        bsz = len(prompt_tokens)
        if bsz > args.max_batch_size:
            raise ValueError(f"batch {bsz} > max_batch_size "
                             f"{args.max_batch_size}")
        device = self.device
        prompt_tokens, max_seq_len = self._truncate(prompt_tokens,
                                                    image_tokens, max_gen_len)
        stop_tokens = tuple(dict.fromkeys(tuple(s) for s in stop_tokens))
        fsm_next, fsm_host = self._fsm_next(fsm)
        if draft_k and bsz == 1:
            return [self._generate_lookup(
                prompt_tokens[0], image_tokens, max_gen_len, stop_tokens,
                draft_k, impl, fsm_next, fsm_host, temperature, top_p, seed,
                lookup_max_n)]

        min_prompt = min(len(t) for t in prompt_tokens)
        max_prompt = max(len(t) for t in prompt_tokens)
        total_len = min(max_seq_len, max_gen_len + max_prompt)

        tokens = torch.zeros((bsz, total_len), dtype=torch.int64)
        in_prompt = torch.zeros((bsz, total_len), dtype=torch.bool)
        for i, t in enumerate(prompt_tokens):
            tokens[i, : len(t)] = torch.tensor(t)
            in_prompt[i, : len(t)] = True
        tokens, in_prompt = tokens.to(device), in_prompt.to(device)
        stops = [torch.tensor(st, device=device) for st in stop_tokens]

        P = _prefill_bucket(min_prompt)
        W = 0 if image_tokens is None else self.image_words
        cache = llama.KVCache.create(
            args, bsz, total_len + W,
            dtype=kv_cache_dtype(self.kv_cache_bits, device), device=device)
        uniforms = self._uniforms(seed, total_len - P, bsz, temperature)
        t0 = time.perf_counter()
        logits, cache, _ = self._prefill(cache, tokens[:, :P], image_tokens,
                                         impl)
        synchronize(device)
        t1 = time.perf_counter()

        V = logits.shape[-1]
        limit = self.vocab_limit if self.vocab_limit is not None else V
        greedy_nofsm = temperature <= 0.0 and fsm_next is None
        pad_mask = torch.arange(V, device=device) >= limit
        stopped = torch.zeros(bsz, dtype=torch.bool, device=device)
        stop_pos = torch.full((bsz,), P + 1, dtype=torch.int64, device=device)
        fstate = torch.zeros(bsz, dtype=torch.int64, device=device)
        steps = 0
        for cur_pos in range(P, total_len):
            if greedy_nofsm:
                next_tok = torch.argmax(logits[:, :limit], dim=-1)
            else:
                # -1e30, not -inf: the softmax input stays finite
                logits = logits.masked_fill(pad_mask, -1e30)
                if fsm_next is not None:
                    # tokens that would kill the answer DFA (or EOS outside
                    # an accepting state) can never be chosen
                    logits = torch.where(fsm_next[fstate] >= 0, logits,
                                         torch.full_like(logits, -1e30))
                next_tok = sample_token(
                    logits, temperature, top_p,
                    uniform=None if uniforms is None
                    else uniforms[cur_pos - P])
            prompt_here = in_prompt[:, cur_pos]
            next_tok = torch.where(prompt_here, tokens[:, cur_pos],
                                   next_tok.long())
            tokens[:, cur_pos] = next_tok
            stop_pos = torch.where(stopped, stop_pos,
                                   torch.full_like(stop_pos, cur_pos + 1))
            for st in stops:
                L = st.numel()
                if cur_pos + 1 - L < 0:
                    continue
                window = tokens[:, cur_pos + 1 - L: cur_pos + 1]
                new_stop = ((window == st[None]).all(dim=1) & ~prompt_here
                            & ~stopped)
                stop_pos = torch.where(new_stop,
                                       torch.full_like(stop_pos,
                                                       cur_pos + 1 - L),
                                       stop_pos)
                stopped = stopped | new_stop
            if fsm_next is not None:
                # the DFA moves on GENERATED tokens only: neither prompt
                # forcing nor sampling after a stop moves the grammar
                nf = fsm_next[fstate, next_tok].long().clamp_min(0)
                fstate = torch.where(prompt_here | stopped, fstate, nf)
            if cur_pos + 1 >= total_len or bool(stopped.all()):
                break
            logits, cache = llama.decode_step(self.params, args, cache,
                                              next_tok[:, None], cur_pos + W,
                                              impl)
            steps += 1
        synchronize(device)
        t2 = time.perf_counter()
        self.last_stats = {"prefill_ms": (t1 - t0) * 1e3,
                           "decode_ms": (t2 - t1) * 1e3,
                           "decode_steps": steps}

        out_tokens = tokens.cpu()
        stop_pos = stop_pos.cpu()
        return [out_tokens[i, len(prompt_tokens[i]): int(stop_pos[i])].tolist()
                for i in range(bsz)]

    def _uniforms(self, seed: int, steps: int, bsz: int, temperature: float):
        """[steps, bsz] uniforms of a sampled request, or None for greedy.
        One draw of one shape per request: the step at index t uses row t in
        the vanilla loop and in the lookup loop alike (a draw of another
        shape need not give the same numbers on CUDA)."""
        if temperature <= 0.0:
            return None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.rand((max(steps, 1), bsz), generator=gen,
                          device=self.device, dtype=torch.float32)

    def _generate_lookup(self, t, image_tokens, max_gen_len, stop_tokens,
                         draft_k, impl, fsm_next, fsm_host, temperature,
                         top_p, seed, lookup_max_n) -> list[int]:
        """One request through prompt-lookup speculation
        (generation.py:588): prefill the FULL prompt (no bucket), choose the
        first token (masked at DFA state 0 under a grammar), then
        ``lookup_generate``. The loop stops on the first single-token stop
        only; multi-token stop sequences are matched HERE with the vanilla
        loop's window semantics (a suffix match ending at a generated
        position, cut at the match's start; windows may straddle the prompt
        boundary), so the returned ids equal the vanilla path's."""
        args, device = self.args, self.device
        _, max_seq_len = self._truncate([t], image_tokens, max_gen_len)
        total_len = min(max_seq_len, max_gen_len + len(t))
        gen_len = total_len - len(t)
        W = 0 if image_tokens is None else self.image_words
        # the last verify window writes up to draft_k rows past the final
        # emitted position
        cache = llama.KVCache.create(
            args, 1, total_len + W + draft_k + 1,
            dtype=kv_cache_dtype(self.kv_cache_bits, device), device=device)
        # the vanilla loop starts at the prefill BUCKET and spends one
        # uniform per in-prompt step before its first generated token, so
        # emitted index i uses row key_offset + i; rows past the last
        # emitted index are never used for an emitted token
        key_offset = len(t) - _prefill_bucket(len(t))
        uniforms = self._uniforms(seed, key_offset + gen_len, 1, temperature)
        if uniforms is not None:
            uniforms = torch.cat([uniforms[key_offset:, 0],
                                  uniforms.new_zeros(draft_k)])
        t0 = time.perf_counter()
        logits, cache, _ = self._prefill(
            cache, torch.tensor([t], device=device), image_tokens, impl)
        V = logits.shape[-1]
        if self.vocab_limit is not None and self.vocab_limit < V:
            logits = logits.masked_fill(
                torch.arange(V, device=device) >= self.vocab_limit, -1e30)
        if fsm_next is not None:
            logits = torch.where(fsm_next[0][None] >= 0, logits,
                                 torch.full_like(logits, -1e30))
        first = int(sample_token(
            logits, temperature, top_p,
            uniform=None if uniforms is None else uniforms[:1])[0])
        synchronize(device)
        t1 = time.perf_counter()
        fsm_state0 = 0
        if fsm_next is not None:
            fsm_state0 = max(int(fsm_host[0, first]), 0)
        singles = [st[0] for st in stop_tokens if len(st) == 1]
        out, count, rounds = lookup_generate(
            self.params, args, cache, t, len(t) + W, first, gen_len=gen_len,
            draft_k=draft_k, vocab_limit=self.vocab_limit,
            stop_token=singles[0] if singles else -1, fsm_next=fsm_next,
            fsm_state0=fsm_state0, temperature=temperature, top_p=top_p,
            sample_uniforms=uniforms, max_n=lookup_max_n, impl=impl,
            fsm_host=fsm_host,
        )
        synchronize(device)
        t2 = time.perf_counter()
        self.last_stats = {"prefill_ms": (t1 - t0) * 1e3,
                           "decode_ms": (t2 - t1) * 1e3,
                           "decode_steps": rounds}
        self.last_spec_stats = {
            "emitted": count,
            "verify_rounds": rounds,
            "tokens_per_round": round(count / max(rounds, 1), 3),
        }
        gen = out[:count].tolist()
        buf = list(t) + gen
        P = len(t)
        cut = len(gen)
        for j in range(len(gen)):  # the earliest stop wins, as in the loop
            cur = P + j
            for st in stop_tokens:
                start = cur + 1 - len(st)
                if start >= 0 and tuple(buf[start: cur + 1]) == st:
                    cut = min(cut, max(start - P, 0))
                    break
            if cut < len(gen):
                break
        return gen[:cut]

    def generate(
        self,
        prompts: Sequence[str],
        image_tokens: Optional[torch.Tensor] = None,
        max_gen_len: int = 512,
        temperature: float = 0.0,
        top_p: float = 0.95,
        additional_stop_symbols: Iterable[str] = (),
        seed: int = 0,
        impl: str = "auto",
        fsm=None,
        draft_k: int = 0,
        lookup_max_n: int = 4,
    ) -> list[str]:
        """Text in, text out through the tokenizer (generation.py:457-586):
        prompts encoded with BOS, stop symbols encoded both as a segment
        and without a prefix space, EOS first. ``fsm``, ``draft_k`` and
        ``lookup_max_n`` as in ``generate_tokens``."""
        if isinstance(prompts, str):
            raise ValueError("generate expects a batched LIST of prompts")
        tok = self.tokenizer
        prompt_tokens = [tok.encode(x, bos=True, eos=False) for x in prompts]
        stops: list[tuple[int, ...]] = [(tok.eos_id,)]
        for sym in additional_stop_symbols:
            stops.append(tuple(tok.encode_segment(sym)))
            stops.append(tuple(tok.encode_wo_prefix_space(sym)))
        out = self.generate_tokens(
            prompt_tokens, image_tokens=image_tokens, max_gen_len=max_gen_len,
            temperature=temperature, top_p=top_p, stop_tokens=stops,
            seed=seed, impl=impl, fsm=fsm, draft_k=draft_k,
            lookup_max_n=lookup_max_n,
        )
        return [tok.decode(t) for t in out]
