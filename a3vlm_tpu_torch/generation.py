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
  decoding (``lookup_decode``), whose output equals this loop's;
- ``ops``: the decoder family's cache, prefill and decode step
  (``LLAMA_GEN_OPS``, or ``FALCON_GEN_OPS``, which has no chunked prefill
  and no lookup decoding: those requests take the one-piece prefill and
  the vanilla loop, as in the JAX ``Generator``);
- ``mesh`` (a ``parallel.Mesh``, generation.py:397-455): every rank runs
  this loop in lockstep over its shard of the weights. The cache holds
  this rank's kv heads ("model") and, where the batch divides over
  "data", this rank's rows; each step's logits are gathered, so every
  rank picks the same tokens. The grammar table is replicated.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.lookup_decode import lookup_generate
from a3vlm_tpu_torch.models import falcon, llama
from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype
from a3vlm_tpu_torch.ops.sampling import sample_token
from a3vlm_tpu_torch.parallel import tp
from a3vlm_tpu_torch.parallel.mesh import DATA_AXIS, on_mesh
from a3vlm_tpu_torch.utils import trace


class GenOps(NamedTuple):
    """A decoder family's generation ops (generation.py:41):
    ``create_cache(args, batch, max_seq_len, dtype, device)``,
    ``prefill(params, args, cache, tokens, image_tokens, impl)``,
    ``decode_step(params, args, cache, token, seq_pos, impl)`` and
    ``prefill_chunked(params, args, cache, tokens, image_tokens, chunk,
    impl)`` or None, and ``cache_specs(args, mesh, batch, quant)``, the
    spec of a cache panel on a mesh."""

    create_cache: Callable
    prefill: Callable
    decode_step: Callable
    prefill_chunked: Optional[Callable] = None
    cache_specs: Optional[Callable] = None


def _llama_cache(args, batch, max_seq_len, dtype, device):
    return llama.KVCache.create(args, batch, max_seq_len, dtype=dtype,
                                device=device)


LLAMA_GEN_OPS = GenOps(_llama_cache, llama.prefill, llama.decode_step,
                       llama.prefill_chunked, llama.decode_cache_specs)


def _falcon_cache(args, batch, max_seq_len, dtype, device):
    return falcon.FalconKVCache.create(args, batch, max_seq_len, dtype=dtype,
                                       device=device)


def _falcon_prefill(params, args, cache, tokens, image_tokens, impl):
    if image_tokens is not None:
        raise ValueError("falcon is text-only (falcon.py:302)")
    return falcon.prefill(params, args, cache, tokens, impl)


# (generation.py:84-125)
FALCON_GEN_OPS = GenOps(_falcon_cache, _falcon_prefill, falcon.decode_step,
                        None, falcon.falcon_cache_specs)


def decoder_device(params: dict) -> torch.device:
    """The device of a decoder tree (its final norm's): ``norm`` of the
    LLaMA decoders, ``ln_f`` of falcon."""
    return (params.get("norm") or params["ln_f"])["weight"].device


def _prefill_bucket(min_prompt: int) -> int:
    p = 1
    while p * 2 <= min_prompt:
        p *= 2
    return p


def row_steps(prompt_lens: Sequence[int], stop_pos: Sequence[int], P: int,
              steps: int, max_gen_len: int) -> dict:
    """What the vanilla loop's ``steps`` decode steps fed each row, summed
    over the rows: the step at position q (q = P, P + 1, ...) feeds row i
    its id at q; ``row_steps_forced`` a prompt id (q < the row's length
    n), ``row_steps_asked`` a generated id of index q - n < ``max_gen_len``
    before the row's stop (q < ``stop_pos[i]``, where its returned ids
    end), ``row_steps_spare`` any other. They sum to rows x ``steps``."""
    end = P + steps
    forced = asked = 0
    for n, stop in zip(prompt_lens, stop_pos):
        forced += max(min(n, end) - P, 0)
        asked += max(min(n + max_gen_len, stop, end) - max(n, P), 0)
    return {"row_steps_forced": forced, "row_steps_asked": asked,
            "row_steps_spare": len(prompt_lens) * steps - forced - asked}


def synchronize(device: torch.device) -> None:
    """Wait for the device, so host clocks bracket its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Generator:
    """Host-side orchestration over one decoder (generation.py:390)."""

    def __init__(self, params: dict, args: ModelArgs, tokenizer=None,
                 image_words: int = 0, vocab_limit: Optional[int] = None,
                 kv_cache_bits: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 ops: GenOps = LLAMA_GEN_OPS, mesh=None):
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
        self.ops = ops
        self.mesh = mesh
        # the numbers of the last call's spans and counters
        # (``trace.Record.stats``): host ms of its phases, synchronized on
        # CUDA, and its step counts
        self.last_stats: dict = {}
        # set by the lookup path (draft_k > 0): emitted tokens and verify
        # rounds of the LAST request
        self.last_spec_stats: Optional[dict] = None
        self._fsm_tables: tuple = (None, None, None)

    @property
    def device(self) -> torch.device:
        return decoder_device(self.params)

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

    def _batch_rows(self, batch: int) -> int:
        """The rows a cache of ``batch`` holds on this rank: a share where
        the family's cache spec puts the batch on "data"."""
        if not tp.is_parallel(self.mesh):
            return batch
        spec = self.ops.cache_specs(self.args, self.mesh, batch)
        return batch // self.mesh.dp_size if spec[0] == DATA_AXIS else batch

    def _prefill(self, cache, tokens, image_tokens, impl):
        """The family's prefill on this rank's rows; every row's logits."""
        B = tokens.shape[0]
        tokens = tp.data_rows(tokens, B, self.mesh)
        image_tokens = tp.data_rows(image_tokens, B, self.mesh)
        if self.prefill_chunk and self.ops.prefill_chunked is not None:
            logits, cache, S = self.ops.prefill_chunked(
                self.params, self.args, cache, tokens, image_tokens,
                self.prefill_chunk, impl)
        else:
            logits, cache, S = self.ops.prefill(self.params, self.args,
                                                cache, tokens, image_tokens,
                                                impl)
        return tp.data_gather(logits, B, self.mesh), cache, S

    def _decode(self, cache, token, seq_pos: int, impl):
        B = token.shape[0]
        logits, cache = self.ops.decode_step(
            self.params, self.args, cache,
            tp.data_rows(token, B, self.mesh), seq_pos, impl)
        return tp.data_gather(logits, B, self.mesh), cache

    def _truncate(self, prompt_tokens, image_tokens, max_gen_len):
        """Left-truncated prompts and the text positions left for them."""
        max_seq_len = self.args.max_seq_len
        if image_tokens is not None:
            max_seq_len -= self.image_words
        return ([list(t)[-(max_seq_len - max_gen_len):]
                 for t in prompt_tokens], max_seq_len)

    @on_mesh
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
        of more than one request, and any request over falcon's ops, takes
        the vanilla loop."""
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
        with trace.call("generate") as rec:
            first = len(rec.spans)
            if draft_k and bsz == 1 and self.ops is LLAMA_GEN_OPS:
                out = [self._generate_lookup(
                    prompt_tokens[0], image_tokens, max_gen_len, stop_tokens,
                    draft_k, impl, fsm_next, fsm_host, temperature, top_p,
                    seed, lookup_max_n)]
            else:
                out = self._generate(prompt_tokens, image_tokens, max_seq_len,
                                     max_gen_len, temperature, top_p,
                                     stop_tokens, seed, impl, fsm_next)
        self.last_stats = rec.stats(first)
        return out

    def _generate(self, prompt_tokens, image_tokens, max_seq_len, max_gen_len,
                  temperature, top_p, stop_tokens, seed, impl,
                  fsm_next) -> list[list[int]]:
        """The vanilla loop (the module's docstring), in the open call's
        spans: ``prefill``, ``decode`` and in it one ``decode.issue``
        (attribute ``forced``: the step feeds some row a prompt id) and one
        ``decode.wait`` (the host blocked on the stop flags) an iteration;
        counters ``decode_steps`` and ``row_steps``'s three."""
        args, device = self.args, self.device
        bsz = len(prompt_tokens)
        prompt_lens = [len(t) for t in prompt_tokens]
        min_prompt, max_prompt = min(prompt_lens), max(prompt_lens)
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
        cache = self.ops.create_cache(
            args, self._batch_rows(bsz), total_len + W,
            kv_cache_dtype(self.kv_cache_bits, device), device)
        uniforms = self._uniforms(seed, total_len - P, bsz, temperature)
        with trace.span("prefill"):
            logits, cache, _ = self._prefill(cache, tokens[:, :P],
                                             image_tokens, impl)
            synchronize(device)

        with trace.span("decode"):
            V = logits.shape[-1]
            limit = self.vocab_limit if self.vocab_limit is not None else V
            greedy_nofsm = temperature <= 0.0 and fsm_next is None
            pad_mask = torch.arange(V, device=device) >= limit
            stopped = torch.zeros(bsz, dtype=torch.bool, device=device)
            stop_pos = torch.full((bsz,), P + 1, dtype=torch.int64,
                                  device=device)
            fstate = torch.zeros(bsz, dtype=torch.int64, device=device)
            steps = 0
            # an iteration: issue (the step that feeds the id chosen at
            # cur_pos - 1, then the choice at cur_pos and its
            # bookkeeping), then wait (the host reads whether every row
            # has stopped)
            cur_pos = P
            while cur_pos < total_len:
                with trace.span("decode.issue", forced=cur_pos <= max_prompt):
                    if cur_pos > P:
                        logits, cache = self._decode(
                            cache, next_tok[:, None], cur_pos - 1 + W, impl)
                        steps += 1
                    if greedy_nofsm:
                        next_tok = torch.argmax(logits[:, :limit], dim=-1)
                    else:
                        # -1e30, not -inf: the softmax input stays finite
                        logits = logits.masked_fill(pad_mask, -1e30)
                        if fsm_next is not None:
                            # tokens that would kill the answer DFA (or EOS
                            # outside an accepting state) can never be
                            # chosen
                            logits = torch.where(
                                fsm_next[fstate] >= 0, logits,
                                torch.full_like(logits, -1e30))
                        next_tok = sample_token(
                            logits, temperature, top_p,
                            uniform=None if uniforms is None
                            else uniforms[cur_pos - P])
                    prompt_here = in_prompt[:, cur_pos]
                    next_tok = torch.where(prompt_here, tokens[:, cur_pos],
                                           next_tok.long())
                    tokens[:, cur_pos] = next_tok
                    stop_pos = torch.where(
                        stopped, stop_pos,
                        torch.full_like(stop_pos, cur_pos + 1))
                    for st in stops:
                        L = st.numel()
                        if cur_pos + 1 - L < 0:
                            continue
                        window = tokens[:, cur_pos + 1 - L: cur_pos + 1]
                        new_stop = ((window == st[None]).all(dim=1)
                                    & ~prompt_here & ~stopped)
                        stop_pos = torch.where(
                            new_stop,
                            torch.full_like(stop_pos, cur_pos + 1 - L),
                            stop_pos)
                        stopped = stopped | new_stop
                    if fsm_next is not None:
                        # the DFA moves on GENERATED tokens only: neither
                        # prompt forcing nor sampling after a stop moves
                        # the grammar
                        nf = fsm_next[fstate, next_tok].long().clamp_min(0)
                        fstate = torch.where(prompt_here | stopped, fstate,
                                             nf)
                if cur_pos + 1 >= total_len:
                    break
                with trace.span("decode.wait"):
                    done = bool(stopped.all())
                if done:
                    break
                cur_pos += 1
            synchronize(device)
        trace.count("decode_steps", steps)

        out_tokens = tokens.cpu()
        stop_pos = stop_pos.cpu()
        for key, n in row_steps(prompt_lens, stop_pos.tolist(), P, steps,
                                max_gen_len).items():
            trace.count(key, n)
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
        with trace.span("prefill"):
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
        with trace.span("decode"):
            fsm_state0 = 0
            if fsm_next is not None:
                fsm_state0 = max(int(fsm_host[0, first]), 0)
            singles = [st[0] for st in stop_tokens if len(st) == 1]
            out, count, rounds = lookup_generate(
                self.params, args, cache, t, len(t) + W, first,
                gen_len=gen_len, draft_k=draft_k,
                vocab_limit=self.vocab_limit,
                stop_token=singles[0] if singles else -1, fsm_next=fsm_next,
                fsm_state0=fsm_state0, temperature=temperature, top_p=top_p,
                sample_uniforms=uniforms, max_n=lookup_max_n, impl=impl,
                fsm_host=fsm_host,
            )
            synchronize(device)
        trace.count("decode_steps", rounds)
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
