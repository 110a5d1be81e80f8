"""Continuous batching (counterpart of a3vlm_tpu/serving_batch.py): a fixed
pool of B cache SLOTS over one layered KV cache, each slot serving one
request at a time.

- admission: a free slot prefills its request into a temporary cache sized
  to its bucket-padded prompt and the rows are copied into the slot's rows
  of the pool. Same-bucket admissions run as ONE batched prefill
  (``_admit_many``); an admission against a ``CachedPrefix`` (the
  ``[BOS | image words]`` of one object render) copies the prefix's rows
  and extends them with the request's text alone.
- decode: ONE ragged step advances every slot (``llama.decode_step_ragged``:
  a position and a valid length per row, which the fused decode kernels
  take natively); ``draft_k > 0`` verifies host-drafted windows instead
  (``llama.decode_step_ragged_multi``, the verify kernels), and
  ``steps_per_dispatch > 1`` runs that many steps with the tokens,
  positions, stop flags and grammar states on the device and reads back one
  [B, T] block.
- completion: a slot that hits EOS or its length limit is freed and the
  next queued request admitted between steps. Finished and idle slots keep
  riding the batched step, rewriting their own last row (a slot never
  admitted sits at position 0 with one valid row); rows past a slot's valid
  length are written before they can be attended, so slot reuse needs no
  zeroing.

The host mirrors of the slots' tokens and positions are the source of
truth: a step uploads them as two tensors instead of writing per slot.
Sampling draws from one ``torch.Generator`` seeded by ``seed`` on the
pool's device: greedy output equals the JAX package's token for token,
sampled output agrees with it in distribution and is reproducible from the
seed.

With ``mesh=`` (serving_batch.py:399-465) the batcher is driven SPMD:
every rank constructs it over its shard of the weights and steps it. The
pool holds this rank's kv heads ("model") and, where the slots divide over
"data", this rank's slots; a ragged step runs on the local slots and
gathers every slot's logits, so every rank keeps the same host state.
Admissions run on every rank, each writing its own slots."""

from __future__ import annotations

import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.models import llama
from a3vlm_tpu_torch.ops.decode_attention import QuantizedKV, kv_cache_dtype
from a3vlm_tpu_torch.ops.norms import rms_norm
from a3vlm_tpu_torch.ops.sampling import sample_top_p
from a3vlm_tpu_torch.parallel import tp
from a3vlm_tpu_torch.parallel.mesh import DATA_AXIS, on_mesh

# masked logits: finite, so the softmax of a sampled pick stays finite
_MASKED = -1e30


def _pick(logits, gen, vocab_limit, temperature, top_p, fsm_rows=None):
    """Greedy or top-p choice over [B, V] logits (serving_batch.py:48) with
    the padded-vocab tail masked. ``fsm_rows``: grammar transition rows
    broadcastable to ``logits`` (-1 = a token the answer DFA forbids).
    Sampling draws one uniform a row from ``gen``."""
    if fsm_rows is not None:
        logits = torch.where(fsm_rows >= 0, logits,
                             torch.full_like(logits, _MASKED))
    V = logits.shape[-1]
    if vocab_limit is not None and vocab_limit < V:
        logits = logits.masked_fill(
            torch.arange(V, device=logits.device) >= vocab_limit, _MASKED)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return sample_top_p(probs, top_p, generator=gen)


def _ragged(step, params, args, cache, tokens, pos):
    """A ragged ``step`` of llama over the pool: on this rank's slots where
    the slots split over "data", every slot's logits back."""
    B = tokens.shape[0]
    logits, cache = step(params, args, cache, tp.data_rows(tokens, B),
                         tp.data_rows(pos, B))
    return tp.data_gather(logits, B), cache


def _ragged_step(params, args, cache, token, pos, gen, vocab_limit,
                 temperature, top_p, fsm_table=None, fsm_state=None):
    """One ragged decode step over the pool (serving_batch.py:68): token
    [B, 1], pos [B] int32. Returns ([B] int32 picks, cache)."""
    logits, cache = _ragged(llama.decode_step_ragged, params, args, cache,
                            token, pos)
    rows = None if fsm_table is None else fsm_table[fsm_state]  # [B, V]
    return _pick(logits, gen, vocab_limit, temperature, top_p, rows), cache


def _ragged_step_chunk(params, args, cache, token, pos, active, remaining,
                       stop_tokens, gen, vocab_limit, temperature, top_p,
                       t_steps, pos_cap, fsm_table=None, fsm_state=None):
    """``t_steps`` ragged decode steps with one readback
    (serving_batch.py:81). Tokens, positions, the emit flags, the tokens
    each slot may still emit and the grammar states stay on the device;
    nothing in the loop waits for the host. A slot stops emitting on a stop
    token, its length limit or the position cap, as the host bookkeeping
    does, and then rewrites its own row, so greedy output equals the
    per-step path's. A sampled run draws uniforms at every step (the JAX
    loop splits its key only while a slot emits): reproducible from the
    seed, not across chunk sizes.

    ``active`` [B] bool, ``remaining`` [B] int32, ``stop_tokens`` [n]
    int32. Returns (tokens [B, t_steps] int32, cache)."""
    B = token.shape[0]
    toks = torch.zeros((B, t_steps), dtype=torch.int32, device=token.device)
    for i in range(t_steps):
        emit = active & (remaining > 0)
        logits, cache = _ragged(llama.decode_step_ragged, params, args,
                                cache, token, pos)
        rows = None if fsm_table is None else fsm_table[fsm_state]
        pick = _pick(logits, gen, vocab_limit, temperature, top_p, rows)
        nxt = torch.where(emit, pick, token[:, 0])
        toks[:, i] = nxt
        if fsm_table is not None:
            walked = fsm_table[fsm_state, nxt].clamp_min(0)
            fsm_state = torch.where(emit, walked, fsm_state)
        hit_stop = (nxt[:, None] == stop_tokens[None, :]).any(dim=-1)
        step = emit.to(torch.int32)
        remaining = remaining - step
        pos = pos + step
        active = emit & ~hit_stop & (remaining > 0) & (pos + 1 < pos_cap)
        token = nxt[:, None]
    return toks, cache


def _ragged_verify_step(params, args, cache, tokens, pos, vocab_limit,
                        fsm_table=None, fsm_states=None):
    """A speculative verify round, greedy (serving_batch.py:151): ``tokens``
    [B, K+1] = [current token | K drafted tokens] a slot. Returns the
    greedy pick at every window position ([B, K+1] int32) and the cache
    with all K+1 rows written. ``fsm_states`` [B, K+1]: the grammar state
    each position's pick must respect, walked along the draft on the host
    (positions past the first illegal draft are never accepted)."""
    logits, cache = _ragged(llama.decode_step_ragged_multi, params, args,
                            cache, tokens, pos)
    if fsm_table is not None:
        rows = fsm_table[fsm_states]  # [B, K+1, V]
        logits = torch.where(rows >= 0, logits,
                             torch.full_like(logits, _MASKED))
    V = logits.shape[-1]
    if vocab_limit is not None and vocab_limit < V:
        logits = logits.masked_fill(
            torch.arange(V, device=logits.device) >= vocab_limit, _MASKED)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def _lookup_draft(ctx: list[int], k: int, max_n: int = 4) -> list[int]:
    """Prompt-lookup drafting on the host (serving_batch.py:172): the ``k``
    tokens that followed the most recent EARLIER occurrence of the LONGEST
    current suffix n-gram (n = max_n .. 1) in the slot's history, padded
    with the last token; no match repeats the last token (accepted 0 still
    emits the one verified token)."""
    n = len(ctx)
    last = ctx[-1]
    if n >= 2:
        a = np.asarray(ctx, np.int64)
        for m in range(min(max_n, n - 1), 0, -1):
            suf = a[n - m:]
            # windows over a[:-1]: a continuation starts strictly before
            # the suffix's own occurrence
            win = np.lib.stride_tricks.sliding_window_view(a[:-1], m)
            hits = np.flatnonzero((win == suf).all(axis=1))
            if hits.size:
                start = int(hits[-1]) + m
                draft = ctx[start: start + k]
                if len(draft) < k:
                    draft = draft + [last] * (k - len(draft))
                return draft
    return [last] * k


def _bucket(n: int) -> int:
    """Admission length bucket (serving_batch.py:203): the next power of two,
    at least 16. Requests of one bucket are admitted together, so the
    bucket sets the schedule (and the step count) as in the JAX package."""
    b = 16
    while b < n:
        b *= 2
    return b


def _head_at(params, args, h, last_idx):
    """float32 logits [B, V] of row b's hidden state at ``last_idx[b]``."""
    h_last = h[torch.arange(h.shape[0], device=h.device), last_idx.long()]
    h_last = rms_norm(h_last, params["norm"]["weight"], args.norm_eps)
    return tp.head(h_last, params["output"]["weight"]).float()


def _prefill(params, args, cache, tokens, image_tokens, last_idx, gen,
             vocab_limit, temperature, top_p, fsm_row=None):
    """Admission prefill of bucket-padded ``tokens`` [B, Tb]
    (serving_batch.py:218), cache rows [0, S) written. ``last_idx`` [B]:
    each row's true last position (the pad after it stays invisible to the
    real positions; its cache rows are rewritten before they can be
    attended). ``image_tokens`` are spliced after BOS. Returns ([B] int32
    first tokens, cache)."""
    h = llama.embed_tokens(params, tokens)
    if image_tokens is not None:
        h = torch.cat([h[:, :1], image_tokens.to(h.dtype), h[:, 1:]], dim=1)
    S = h.shape[1]
    h, cache = llama.forward_hidden(
        params, args, h, torch.arange(S, device=h.device), "causal",
        cache=cache, write_pos=0, attend_cache=False)
    logits = _head_at(params, args, h, last_idx)
    return _pick(logits, gen, vocab_limit, temperature, top_p, fsm_row), cache


def _extend(params, args, cache, tokens, start, last_idx, gen, vocab_limit,
            temperature, top_p, fsm_row=None):
    """Extend a cache that holds a ``start``-row prefix with bucket-padded
    ``tokens`` [B, Tb] (no BOS: the prefix owns it), the prefix-cache
    admission (serving_batch.py:252): rows [start, start + Tb) written,
    right-aligned causal attention over the populated prefix (the flash
    kernel's chunk route on the card). ``last_idx`` is each row's true last
    text index."""
    h = llama.embed_tokens(params, tokens)
    B, T, _ = h.shape
    out, cache = llama.forward_hidden(
        params, args, h, torch.arange(start, start + T, device=h.device),
        "causal", cache=cache, write_pos=start,
        kv_valid_len=torch.full((B,), start + T, dtype=torch.int32,
                                device=h.device),
        attend_cache=True, attend_valid_static=start + T)
    logits = _head_at(params, args, out, last_idx)
    return _pick(logits, gen, vocab_limit, temperature, top_p, fsm_row), cache


def _panels(cache):
    """Every tensor of a layered cache, in a fixed order: each layer's k
    then v, and of an int8 layer its values then its scales."""
    for c in (*cache.k, *cache.v):
        if isinstance(c, QuantizedKV):
            yield c.qv
            yield c.scale
        else:
            yield c


def _copy_prefix(dst, src, rows: int):
    """Copy the first ``rows`` rows of a batch-1 prefix cache into a longer
    temporary cache, over every row of its batch (serving_batch.py:283).
    In place; returns ``dst``."""
    for d, s in zip(_panels(dst), _panels(src)):
        d[:, :, :rows] = s[:, :, :rows]
    return dst


class CachedPrefix:
    """A reusable KV prefix (serving_batch.py:296), e.g. [BOS | image
    words], the shared part of every question about one object render.
    ``cache``: batch-1 layered panels holding rows [0, length);
    ``tokens``: the prefix's TEXT ids (no image words; the speculative
    mode's drafting context)."""

    def __init__(self, cache, length: int, tokens=None):
        self.cache = cache
        self.length = length
        self.tokens = list(tokens) if tokens is not None else []


def _write_slots(cache, temp, slots, first: int = 0):
    """Copy a batch-B temporary cache into B pool slots (``slots``, B
    ints; one for a batch-1 admission), one indexed copy a tensor
    (serving_batch.py:310, :326). The temporary holds no more rows than the
    pool; the pool's rows past it keep stale data, never attendable before
    they are rewritten. In place. ``first``: the first slot the pool holds
    (its slots split over "data"); slots it does not hold are skipped."""
    device = next(_panels(cache)).device
    n = next(_panels(cache)).shape[0]
    rows = [(i, s - first) for i, s in enumerate(slots)
            if first <= s < first + n]
    if not rows:
        return cache
    src = None
    if len(rows) < len(slots):
        src = torch.tensor([i for i, _ in rows], device=device)
    idx = torch.tensor([s for _, s in rows], device=device)
    for pool, tmp in zip(_panels(cache), _panels(temp)):
        pool[idx, :, :tmp.shape[2]] = tmp if src is None else tmp[src]
    return cache


class ContinuousBatcher:
    """Slot-based continuous batching over a pooled KV cache
    (serving_batch.py:342). ``params``: the decoder (per-layer list, as the
    port keeps it); per-request ``max_gen_len`` and EOS stop."""

    @torch.inference_mode()
    def __init__(
        self,
        params,
        args: ModelArgs,
        tokenizer,
        slots: int = 4,
        max_seq_len: Optional[int] = None,
        kv_cache_bits: Optional[int] = None,
        ens5_params=None,
        ens5_cfg=None,
        vocab_limit: Optional[int] = None,
        seed: int = 0,
        mesh=None,
        draft_k: int = 0,
        fsm=None,
        steps_per_dispatch: int = 1,
        device: torch.device | str = "cuda",
    ):
        """``ens5_params`` / ``ens5_cfg``: the whole llama_ens5 tree and its
        config, to serve IMAGE-conditioned requests (admission runs the
        towers and splices the image words).

        ``draft_k > 0``: prompt-lookup speculative decoding in the pool,
        greedy only: each round verifies ``draft_k`` host-drafted tokens a
        slot in one (K+1)-token forward, output equal to vanilla greedy.
        The pool carries ``draft_k + 1`` spare rows, so the last verify
        window of a slot stays inside the pool.

        ``fsm``: a ``constrained.TokenFsm``; every slot's tokens are masked
        to the answer grammar (a DFA state a slot, reset at admission).

        ``steps_per_dispatch > 1`` (vanilla decode only): each round runs
        that many steps with one readback (``_ragged_step_chunk``); output
        equals the per-step path's, admissions land at chunk boundaries.

        ``device``: where the pool lives; the weights must lie there.
        ``mesh``: the ``parallel.Mesh`` whose shard of the weights
        ``params`` (and ``ens5_params``) hold; every rank constructs the
        batcher and steps it (module docstring)."""
        if kv_cache_bits not in (None, 8):
            raise ValueError(f"kv_cache_bits {kv_cache_bits}: want None or 8")
        weights = params["norm"]["weight"].device
        if torch.device(device).type != weights.type:
            raise ValueError(f"the weights lie on {weights}, not on {device}")
        self.device = weights
        self.mesh = mesh
        self.params = params
        self.args = args
        self.ens5_params = ens5_params
        self.ens5_cfg = ens5_cfg
        self.vocab_limit = vocab_limit
        self.tokenizer = tokenizer
        self.slots = slots
        self.max_seq_len = max_seq_len or args.max_seq_len
        self.draft_k = int(draft_k)
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be at least 1")
        if self.draft_k and self.steps_per_dispatch > 1:
            raise ValueError("speculative mode drafts on the host every "
                             "round; steps_per_dispatch applies to vanilla "
                             "decode only")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._temperature = 0.0
        self._top_p = 0.95
        self._cache_dtype = kv_cache_dtype(kv_cache_bits, self.device)
        # a verify window writes up to draft_k rows past a slot's last
        # emitted position: spare rows keep those writes inside the pool
        pool_rows = self.max_seq_len + (
            self.draft_k + 1 if self.draft_k else 0)
        self.cache = self._new_cache(slots, pool_rows, pool=True)
        # the first slot this rank's pool holds
        self._slot0 = 0
        if next(_panels(self.cache)).shape[0] < slots:  # split over "data"
            self._slot0 = mesh.data_index * (slots // mesh.dp_size)
        self._host_tok = np.zeros((slots, 1), np.int32)
        self._host_pos = np.zeros((slots,), np.int64)
        self._active: list[Optional[int]] = [None] * slots
        # per-slot history (prompt text + emitted), speculative mode only
        self._ctx: list[list[int]] = [[] for _ in range(slots)]
        # the grammar: a device table for the masks, a host one for the
        # per-slot state walks (generation.Generator._fsm_next's layout)
        self._fsm_np = None
        self._fsm_dev = None
        self._fsm_row0 = None
        self._fsm_state = np.zeros((slots,), np.int32)
        if fsm is not None:
            nxt = np.asarray(fsm.next_state)
            pad = args.vocab_size - nxt.shape[1]
            if pad < 0:
                raise ValueError(f"fsm table {nxt.shape} wider than the "
                                 f"logits ({args.vocab_size})")
            if pad:  # the lane-padded vocab tail: never legal
                nxt = np.pad(nxt, ((0, 0), (0, pad)), constant_values=-1)
            self._fsm_np = np.ascontiguousarray(nxt, np.int32)
            self._fsm_dev = torch.from_numpy(self._fsm_np).to(self.device)
            self._fsm_row0 = self._fsm_dev[0]  # admission: DFA state 0
        self.steps = 0  # batched ragged steps (or verify rounds) taken
        self.last_stats: Optional[dict] = None  # set by each generate()
        # per-request admit / finish times; generate() resets them, an
        # OnlineSession installs its own
        self._admit_t: dict[int, float] = {}
        self._finish_t: dict[int, float] = {}

    # -- internal ------------------------------------------------------------

    @on_mesh
    def _new_cache(self, batch: int, rows: int, pool: bool = False):
        """A cache of ``batch`` rows; the ``pool``'s slots split over
        "data" where ``llama.decode_cache_specs`` puts them there."""
        if pool and tp.is_parallel(self.mesh) and llama.decode_cache_specs(
                self.args, self.mesh, batch)[0] == DATA_AXIS:
            batch //= self.mesh.dp_size
        return llama.KVCache.create(self.args, batch, max_seq_len=rows,
                                    dtype=self._cache_dtype,
                                    device=self.device)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _fsm_state_dev(self):
        return (None if self._fsm_dev is None
                else self._upload(self._fsm_state))

    @torch.inference_mode()
    @on_mesh
    def warmup(self, buckets=(64, 128, 256, 512), groups=(1, 2, 4, 8),
               prefix_len: Optional[int] = None, temperature: float = 0.0,
               top_p: float = 0.95):
        """Run every admission shape a serving run over ``buckets``-sized
        prompts takes, and one decode round, before the serving loop
        (serving_batch.py:477): the first calls load the kernel library and
        fill the per-device split caches of the decode, verify and GEMV
        kernels. One admission per (group x bucket), against a zero
        prefix of ``prefix_len`` rows when given, then one ragged step
        (or verify round, or chunk). Leaves output and state as before:
        the pool's mirrors, the step count and the sampling generator are
        restored; the garbage rows are never attendable."""
        if any(a is not None for a in self._active):
            raise RuntimeError("warmup needs an idle pool")
        self._temperature = float(temperature)
        self._top_p = float(top_p)
        steps0 = self.steps
        rng = self._gen.get_state()
        prefix = None
        if prefix_len is not None:
            prefix = CachedPrefix(self._new_cache(1, prefix_len), prefix_len,
                                  tokens=[self.tokenizer.bos_id])
        start = prefix_len or 0
        for Tb in buckets:
            if -(-(start + Tb) // 8) * 8 > self.max_seq_len:
                continue  # near-max prompts take the exact-length path
            for g in groups:
                if g > self.slots:
                    continue
                toks = [self.tokenizer.bos_id] + [0] * (Tb - 1)
                text = [0] * Tb  # prefix admission strips BOS upstream
                self._admit_many([
                    (s, s, text if prefix is not None else toks, None,
                     prefix)
                    for s in range(g)
                ])
                self._active = [None] * self.slots
        zeros = torch.zeros((self.slots,), dtype=torch.int32,
                            device=self.device)
        if self.draft_k:
            K = self.draft_k
            fsm_states = (None if self._fsm_np is None else torch.zeros(
                (self.slots, K + 1), dtype=torch.int32, device=self.device))
            _, self.cache = _ragged_verify_step(
                self.params, self.args, self.cache,
                torch.zeros((self.slots, K + 1), dtype=torch.int32,
                            device=self.device),
                zeros, self.vocab_limit, self._fsm_dev, fsm_states)
        elif self.steps_per_dispatch > 1:
            # inactive slots: the chunk rewrites row 0 of each
            _, self.cache = _ragged_step_chunk(
                self.params, self.args, self.cache, zeros[:, None], zeros,
                zeros.bool(), zeros,
                torch.tensor([self.tokenizer.eos_id], dtype=torch.int32,
                             device=self.device),
                self._gen, self.vocab_limit, self._temperature, self._top_p,
                self.steps_per_dispatch, int(self.max_seq_len),
                self._fsm_dev, self._fsm_state_dev())
        else:
            _, self.cache = _ragged_step(
                self.params, self.args, self.cache, zeros[:, None], zeros,
                self._gen, self.vocab_limit, self._temperature, self._top_p,
                self._fsm_dev, self._fsm_state_dev())
        self._host_tok[:] = 0
        self._host_pos[:] = 0
        self._fsm_state[:] = 0
        self._ctx = [[] for _ in range(self.slots)]
        self.steps = steps0
        self._gen.set_state(rng)

    @torch.inference_mode()
    @on_mesh
    def make_prefix(self, image=None, tokens=None) -> CachedPrefix:
        """A reusable KV prefix (serving_batch.py:571): ``[BOS | image
        words]`` when ``image`` (HWC, CLIP-normalized) is given, then
        ``tokens`` (a shared system prompt, say). The eval workload asks
        about 12 questions per object render; with its 1456-row image
        prefix cached, each admission is a text-only extension."""
        toks = [self.tokenizer.bos_id] + list(tokens or [])
        image_tokens = None
        length = len(toks)
        if image is not None:
            image_tokens = self._encode_image(image)
            length += self.ens5_cfg.image_words
        cache1 = self._new_cache(1, length)
        _, cache1 = _prefill(
            self.params, self.args, cache1,
            torch.tensor([toks], device=self.device), image_tokens,
            torch.tensor([length - 1], device=self.device), self._gen,
            self.vocab_limit, 0.0, 1.0)
        return CachedPrefix(cache1, length, tokens=toks)

    def _encode_image(self, image):
        """One HWC image -> image tokens [1, image_words, D] through the
        towers (``ens5.build_image_tokens``)."""
        if self.ens5_params is None or self.ens5_cfg is None:
            raise ValueError("image requests need ens5_params and ens5_cfg")
        from a3vlm_tpu_torch.models import ens5

        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image))
        image = image.to(self.device, self.ens5_params["start_img"].dtype)
        return ens5.build_image_tokens(self.ens5_params, self.ens5_cfg,
                                       image[None])

    def _take(self, slot, req_idx, first, pos, ctx) -> None:
        """A slot starts serving ``req_idx`` after its admission chose
        ``first`` at position ``pos - 1``."""
        self._host_tok[slot, 0] = first
        self._host_pos[slot] = pos
        self._active[slot] = req_idx
        self._ctx[slot] = list(ctx) + [first]
        if self._fsm_np is not None:
            self._fsm_state[slot] = max(int(self._fsm_np[0, first]), 0)

    def _admit_with_prefix(self, slot, req_idx, toks, prefix: CachedPrefix):
        """Prefix-cache admission (serving_batch.py:608): copy the shared
        rows, extend with the request's text alone."""
        text = toks[1:] if toks and toks[0] == self.tokenizer.bos_id else toks
        Tb = _bucket(len(text))
        if -(-(prefix.length + Tb) // 8) * 8 > self.max_seq_len:
            # near-max prompts: the exact token count (only the cache
            # length rounds); generate()'s capacity check keeps the
            # rounded cache within the pool
            Tb = len(text)
        padded = list(text) + [0] * (Tb - len(text))
        temp = self._new_cache(1, prefix.length + Tb)
        temp = _copy_prefix(temp, prefix.cache, prefix.length)
        first_arr, temp = _extend(
            self.params, self.args, temp,
            torch.tensor([padded], device=self.device), prefix.length,
            torch.tensor([len(text) - 1], device=self.device), self._gen,
            self.vocab_limit, self._temperature, self._top_p, self._fsm_row0)
        first = int(first_arr[0])
        self.cache = _write_slots(self.cache, temp, [slot], self._slot0)
        self._take(slot, req_idx, first, prefix.length + len(text),
                   list(prefix.tokens) + list(text))
        return first

    def _admit(self, slot: int, req_idx: int, toks: list[int], image=None,
               prefix: Optional[CachedPrefix] = None):
        """Batch-1 admission (serving_batch.py:645): the prompt (with its
        image words) prefilled at its bucket into a temporary cache, then
        copied into the slot."""
        if prefix is not None:
            return self._admit_with_prefix(slot, req_idx, toks, prefix)
        image_tokens = None
        W = 0
        if image is not None:
            image_tokens = self._encode_image(image)
            W = self.ens5_cfg.image_words
        Tb = _bucket(len(toks))
        if -(-(W + Tb) // 8) * 8 > self.max_seq_len:
            Tb = len(toks)  # near-max prompts: the exact token count
        padded = list(toks) + [0] * (Tb - len(toks))
        cache1 = self._new_cache(1, W + Tb)
        first_arr, cache1 = _prefill(
            self.params, self.args, cache1,
            torch.tensor([padded], device=self.device), image_tokens,
            torch.tensor([W + len(toks) - 1], device=self.device), self._gen,
            self.vocab_limit, self._temperature, self._top_p, self._fsm_row0)
        first = int(first_arr[0])
        self.cache = _write_slots(self.cache, cache1, [slot], self._slot0)
        self._take(slot, req_idx, first, W + len(toks), toks)
        return first

    def _admit_group(self, items, Tb: int, prefix: Optional[CachedPrefix]):
        """Batched admission (serving_batch.py:684): B same-bucket requests
        ([(slot, req_idx, text_tokens)]) prefilled, or extended from one
        prefix, in ONE forward, which reads the weights once for all B."""
        B = len(items)
        start = prefix.length if prefix is not None else 0
        temp = self._new_cache(B, start + Tb)
        tokens = torch.tensor([list(t) + [0] * (Tb - len(t))
                               for _, _, t in items], device=self.device)
        last = torch.tensor([len(t) - 1 for _, _, t in items],
                            device=self.device)
        if prefix is not None:
            temp = _copy_prefix(temp, prefix.cache, prefix.length)
            firsts, temp = _extend(
                self.params, self.args, temp, tokens, start, last, self._gen,
                self.vocab_limit, self._temperature, self._top_p,
                self._fsm_row0)
        else:
            firsts, temp = _prefill(
                self.params, self.args, temp, tokens, None, last, self._gen,
                self.vocab_limit, self._temperature, self._top_p,
                self._fsm_row0)
        self.cache = _write_slots(self.cache, temp,
                                  [s for s, _, _ in items], self._slot0)
        firsts = firsts.cpu().numpy()
        pre = list(prefix.tokens) if prefix is not None else []
        out = {}
        for b, (slot, req_idx, text) in enumerate(items):
            first = int(firsts[b])
            self._take(slot, req_idx, first, start + len(text),
                       pre + list(text))
            out[req_idx] = first
        return out

    @on_mesh
    def _admit_many(self, items) -> dict:
        """Admit a set of requests, ``items`` [(slot, req_idx, toks, image,
        prefix)], batching where it can (serving_batch.py:737): the same
        bucket and the same prefix object (or both none), text only (an
        image admission runs the towers, batch 1). Groups are split into
        8, 4 and 2. Returns {req_idx: first_token}."""
        bos = self.tokenizer.bos_id
        groups: dict = {}
        singles = []
        firsts: dict = {}
        for it in items:
            slot, req_idx, toks, image, prefix = it
            if image is not None:
                singles.append(it)
                continue
            if prefix is not None:
                text = toks[1:] if toks and toks[0] == bos else toks
                Tb = _bucket(len(text))
                if -(-(prefix.length + Tb) // 8) * 8 > self.max_seq_len:
                    singles.append(it)  # near-max: the exact-length path
                    continue
                groups.setdefault((id(prefix), Tb), []).append(
                    (slot, req_idx, text, prefix))
            else:
                Tb = _bucket(len(toks))
                if -(-Tb // 8) * 8 > self.max_seq_len:
                    singles.append(it)
                    continue
                groups.setdefault((None, Tb), []).append(
                    (slot, req_idx, toks, None))
        for (_, Tb), g in groups.items():
            while g:
                take = next((c for c in (8, 4, 2) if len(g) >= c), 1)
                chunk, g = g[:take], g[take:]
                if take == 1:
                    slot, req_idx, text, prefix = chunk[0]
                    singles.append((slot, req_idx, text, None, prefix))
                    continue
                firsts.update(self._admit_group(
                    [(s, r, t) for s, r, t, _ in chunk], Tb, chunk[0][3]))
        for slot, req_idx, toks, image, prefix in singles:
            firsts[req_idx] = self._admit(slot, req_idx, toks, image=image,
                                          prefix=prefix)
        return firsts

    def _finished(self, slot: int, idx: int, t: int, out_tokens, gen_lims,
                  stops, additional_stop_symbols) -> bool:
        """Whether request ``idx`` in ``slot`` ends after emitting ``t``:
        a stop token, its length limit, the pool's position cap, or a stop
        string in the decoded tail (the '###' separator)."""
        done = (t in stops or len(out_tokens[idx]) >= gen_lims[idx]
                or self._host_pos[slot] + 1 >= self.max_seq_len)
        if not done and additional_stop_symbols:
            tail = self.tokenizer.decode(out_tokens[idx][-8:])
            done = any(sym in tail for sym in additional_stop_symbols)
        return done

    def _emit(self, slot: int, idx: int, t: int, out_tokens) -> None:
        out_tokens[idx].append(t)
        self._host_pos[slot] += 1
        if self._fsm_np is not None:
            self._fsm_state[slot] = max(
                int(self._fsm_np[self._fsm_state[slot], t]), 0)

    @on_mesh
    def _speculative_round(self, out_tokens, gen_lims, stops,
                           additional_stop_symbols):
        """One prompt-lookup verify round over all slots, greedy
        (serving_batch.py:791): draft ``draft_k`` tokens a slot from its
        history, verify the whole pool in one (K+1)-token ragged forward,
        emit each slot's accepted prefix and one bonus token, with the
        vanilla loop's per-token bookkeeping, so the output is vanilla
        greedy's."""
        K = self.draft_k
        drafts = np.zeros((self.slots, K), np.int32)
        for slot in range(self.slots):
            if self._active[slot] is not None:
                drafts[slot] = _lookup_draft(self._ctx[slot], K)
        window = np.concatenate([self._host_tok, drafts], axis=1)  # [B, K+1]
        fsm_states = None
        if self._fsm_np is not None:
            # position j is masked by the DFA walked along drafts[0..j-1];
            # a dead walk clamps to 0, harmless: the illegal draft stops
            # acceptance before a clamped position can be emitted
            fsm_states = np.zeros((self.slots, K + 1), np.int32)
            for slot in range(self.slots):
                if self._active[slot] is None:
                    continue
                st = int(self._fsm_state[slot])
                fsm_states[slot, 0] = st
                for j in range(1, K + 1):
                    if st >= 0:
                        st = int(self._fsm_np[st, window[slot, j]])
                    fsm_states[slot, j] = max(st, 0)
        preds, self.cache = _ragged_verify_step(
            self.params, self.args, self.cache, self._upload(window),
            self._upload(self._host_pos.astype(np.int32)), self.vocab_limit,
            self._fsm_dev,
            None if fsm_states is None else self._upload(fsm_states))
        self.steps += 1
        preds = preds.cpu().numpy()
        for slot in range(self.slots):
            idx = self._active[slot]
            if idx is None:
                continue  # idle: rewrites its own rows in the spare region
            m = 0  # accepted drafts: the longest verified prefix
            while m < K and preds[slot, m] == window[slot, m + 1]:
                m += 1
            done = False
            emitted = 0
            for j in range(m + 1):  # accepted drafts + the bonus token
                t = int(preds[slot, j])
                self._emit(slot, idx, t, out_tokens)
                self._ctx[slot].append(t)
                emitted += 1
                done = self._finished(slot, idx, t, out_tokens, gen_lims,
                                      stops, additional_stop_symbols)
                if done:
                    break
            if done:
                self._active[slot] = None
                self._finish_t[idx] = time.perf_counter()
            else:
                self._host_tok[slot, 0] = int(preds[slot, emitted - 1])

    @on_mesh
    def _decode_round_chunked(self, out_tokens, gen_lims, stops,
                              additional_stop_symbols):
        """``steps_per_dispatch`` ragged steps and one readback
        (serving_batch.py:872); the host walk below mirrors the device
        loop's stop logic, so a slot's tokens equal the per-step path's;
        finish times land at chunk granularity."""
        T = self.steps_per_dispatch
        active = np.array([a is not None for a in self._active], bool)
        remaining = np.zeros((self.slots,), np.int32)
        for slot, idx in enumerate(self._active):
            if idx is not None:
                remaining[slot] = gen_lims[idx] - len(out_tokens[idx])
        toks, self.cache = _ragged_step_chunk(
            self.params, self.args, self.cache, self._upload(self._host_tok),
            self._upload(self._host_pos.astype(np.int32)),
            self._upload(active), self._upload(remaining),
            self._upload(np.asarray(sorted(stops), np.int32)), self._gen,
            self.vocab_limit, self._temperature, self._top_p, T,
            int(self.max_seq_len), self._fsm_dev, self._fsm_state_dev())
        self.steps += T
        toks = toks.cpu().numpy()
        now = time.perf_counter()
        for slot in range(self.slots):
            idx = self._active[slot]
            if idx is None:
                continue
            done = False
            for j in range(T):
                t = int(toks[slot, j])
                self._emit(slot, idx, t, out_tokens)
                self._host_tok[slot, 0] = t
                done = self._finished(slot, idx, t, out_tokens, gen_lims,
                                      stops, additional_stop_symbols)
                if done:
                    break
            if done:
                self._active[slot] = None
                self._finish_t[idx] = now

    @on_mesh
    def _decode_round(self, out_tokens, gen_lims, stops,
                      additional_stop_symbols):
        """One vanilla ragged step over all slots and the per-slot
        bookkeeping (serving_batch.py:930)."""
        nxt, self.cache = _ragged_step(
            self.params, self.args, self.cache, self._upload(self._host_tok),
            self._upload(self._host_pos.astype(np.int32)), self._gen,
            self.vocab_limit, self._temperature, self._top_p, self._fsm_dev,
            self._fsm_state_dev())
        self.steps += 1
        nxt = nxt.cpu().numpy()
        for slot in range(self.slots):
            idx = self._active[slot]
            if idx is None:
                continue  # idle: token and position unchanged
            t = int(nxt[slot])
            self._emit(slot, idx, t, out_tokens)
            self._host_tok[slot, 0] = t
            if self._finished(slot, idx, t, out_tokens, gen_lims, stops,
                              additional_stop_symbols):
                self._active[slot] = None
                self._finish_t[idx] = time.perf_counter()

    def _build_stats(self, t0: float, out_tokens: dict) -> dict:
        """Per-request latency of the finished generate() call
        (serving_batch.py:977): TTFT (queue wait + admission: the first
        token lands at admission), TPOT (decode seconds a token after the
        first) and the pool's throughput."""
        per = []
        for i, toks in out_tokens.items():
            if i not in self._admit_t:
                continue  # never admitted
            ttft = self._admit_t[i] - t0
            fin = self._finish_t.get(i, self._admit_t[i])
            dec = max(fin - self._admit_t[i], 0.0)
            n = len(toks)
            per.append({
                "tokens": n,
                "ttft_s": ttft,
                "tpot_ms": 1e3 * dec / (n - 1) if n > 1 else 0.0,
            })
        if not per:
            return {"requests": 0}
        return _summary(per, max(self._finish_t.values()) - t0)

    def _admit_pairs(self, pairs, out_tokens, gen_lims, stops) -> None:
        """Admit ``pairs`` [(slot, req_idx, toks, image, prefix)] and book
        each first token; a request that ends there frees its slot."""
        firsts = self._admit_many(pairs)
        now = time.perf_counter()
        for slot, idx, *_ in pairs:
            first = firsts[idx]
            self._admit_t[idx] = now
            out_tokens[idx].append(first)
            if first in stops or gen_lims[idx] <= 1:
                self._active[slot] = None
                self._finish_t[idx] = now

    # -- API -----------------------------------------------------------------

    def online(self, temperature: float = 0.0, top_p: float = 0.95,
               additional_stop_tokens: Sequence[int] = (),
               additional_stop_symbols: Sequence[str] = ()):
        """An arrival-time serving session over this pool
        (serving_batch.py:1022): ``submit()`` at any time, ``step()``
        advances every active slot one round. The sampling settings are
        the pool's, fixed for the session. Do not interleave ``generate``
        calls with an open session: both own the pool."""
        return OnlineSession(
            self, temperature=temperature, top_p=top_p,
            additional_stop_tokens=additional_stop_tokens,
            additional_stop_symbols=additional_stop_symbols)

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[str],
        max_gen_len: int | Sequence[int] = 64,
        additional_stop_tokens: Sequence[int] = (),
        additional_stop_symbols: Sequence[str] = (),
        images: Optional[Sequence] = None,
        temperature: float = 0.0,
        top_p: float = 0.95,
        prefixes: Optional[Sequence] = None,
    ) -> list[str]:
        """Run all prompts to completion through the pool
        (serving_batch.py:1038), admitted in arrival order as slots free
        up, so short requests do not wait for long ones. ``max_gen_len``
        may be per request. Returns the decoded generations in input
        order."""
        tok = self.tokenizer
        self._temperature = float(temperature)
        self._top_p = float(top_p)
        if self.draft_k and self._temperature != 0.0:
            raise ValueError("speculative continuous batching (draft_k > 0) "
                             "is greedy only")
        reqs = [tok.encode(p, bos=True, eos=False) for p in prompts]
        gen_lims = (list(max_gen_len) if not isinstance(max_gen_len, int)
                    else [max_gen_len] * len(reqs))
        if len(gen_lims) != len(reqs):
            raise ValueError(f"{len(gen_lims)} max_gen_len for "
                             f"{len(reqs)} prompts")
        for i, (r, g) in enumerate(zip(reqs, gen_lims)):
            self._check_capacity(
                r, g, None if images is None else images[i],
                None if prefixes is None else prefixes[i])
        queue = deque(range(len(reqs)))
        out_tokens: dict[int, list[int]] = {i: [] for i in range(len(reqs))}
        stops = {tok.eos_id, *additional_stop_tokens}
        # offline-batch semantics: every request arrives at t0, so TTFT
        # holds its queue wait
        t0 = time.perf_counter()
        self._admit_t = {}
        self._finish_t = {}
        while queue or any(a is not None for a in self._active):
            pairs = []
            for slot in range(self.slots):
                if self._active[slot] is None and queue:
                    idx = queue.popleft()
                    pairs.append((
                        slot, idx, reqs[idx],
                        None if images is None else images[idx],
                        None if prefixes is None else prefixes[idx]))
            if pairs:
                self._admit_pairs(pairs, out_tokens, gen_lims, stops)
            if not any(a is not None for a in self._active):
                continue
            if self.draft_k:
                self._speculative_round(out_tokens, gen_lims, stops,
                                        additional_stop_symbols)
            elif self.steps_per_dispatch > 1:
                self._decode_round_chunked(out_tokens, gen_lims, stops,
                                           additional_stop_symbols)
            else:
                self._decode_round(out_tokens, gen_lims, stops,
                                   additional_stop_symbols)
        self.last_stats = self._build_stats(t0, out_tokens)
        return [_text(tok, out_tokens[i], stops, additional_stop_symbols)
                for i in range(len(reqs))]

    def _check_capacity(self, toks, max_gen_len, image, prefix) -> None:
        """A request must fit the pool: prompt (a prefix admission splices
        the text without BOS after the prefix), image words or prefix, and
        ``max_gen_len`` new tokens."""
        n = len(toks)
        if prefix is not None:
            w = prefix.length
            if toks and toks[0] == self.tokenizer.bos_id:
                n -= 1  # the prefix owns BOS
        else:
            w = (self.ens5_cfg.image_words
                 if image is not None and self.ens5_cfg is not None else 0)
        if n + w + max_gen_len > self.max_seq_len:
            raise ValueError(f"request of {n} ids + {w} prefix rows + "
                             f"{max_gen_len} new ids exceeds the pool's "
                             f"{self.max_seq_len} rows")


def _text(tok, toks, stops, stop_symbols) -> str:
    """Raw ids -> the answer text: cut at the first of each stop token,
    decoded, cut at each stop string."""
    for s in stops:
        if s in toks:
            toks = toks[: toks.index(s)]
    text = tok.decode(toks)
    for sym in stop_symbols:
        if sym in text:
            text = text.split(sym)[0]
    return text


def _summary(per: list[dict], total: float) -> dict:
    """The stats schema of ``last_stats`` and ``OnlineSession.stats``."""

    def pct(vals, q):
        v = sorted(vals)
        return v[min(int(q * (len(v) - 1) + 0.5), len(v) - 1)]

    ttfts = [p["ttft_s"] for p in per]
    tpots = [p["tpot_ms"] for p in per if p["tokens"] > 1]
    ntok = sum(p["tokens"] for p in per)
    return {
        "requests": len(per),
        "total_s": total,
        "tokens": ntok,
        "tokens_per_sec": ntok / total if total > 0 else 0.0,
        "ttft_p50_s": pct(ttfts, 0.5),
        "ttft_p95_s": pct(ttfts, 0.95),
        "tpot_p50_ms": pct(tpots, 0.5) if tpots else 0.0,
        "tpot_p95_ms": pct(tpots, 0.95) if tpots else 0.0,
        "per_request": per,
    }


class OnlineSession:
    """Arrival-time continuous batching (serving_batch.py:1145):
    ``submit()`` enqueues a request at any time and returns its id;
    ``step()`` admits queued requests into free slots, then advances every
    active slot one round (one token, or one verify window with
    ``draft_k``); ``poll()`` reads a request's output so far; ``drain()``
    steps until idle. A request's output equals what ``generate()`` gives
    for the same prompt; TTFT in ``stats()`` counts from SUBMIT time."""

    def __init__(self, cb: ContinuousBatcher, temperature: float = 0.0,
                 top_p: float = 0.95,
                 additional_stop_tokens: Sequence[int] = (),
                 additional_stop_symbols: Sequence[str] = ()):
        if cb.draft_k and temperature != 0.0:
            raise ValueError("speculative continuous batching (draft_k > 0) "
                             "is greedy only")
        self.cb = cb
        cb._temperature = float(temperature)
        cb._top_p = float(top_p)
        # session-scoped time sinks, which the rounds write through the
        # batcher
        cb._admit_t = {}
        cb._finish_t = {}
        self.stops = {cb.tokenizer.eos_id, *additional_stop_tokens}
        self.stop_syms = tuple(additional_stop_symbols)
        self.queue: deque[int] = deque()
        self.out_tokens: dict[int, list[int]] = {}
        self.gen_lims: dict[int, int] = {}
        self._toks: dict[int, list[int]] = {}
        self._images: dict = {}
        self._prefixes: dict = {}
        self._arrival: dict[int, float] = {}
        self._next_id = 0

    def submit(self, prompt: str, max_gen_len: int = 64, image=None,
               prefix: Optional[CachedPrefix] = None) -> int:
        """Enqueue one request; returns its id. It is admitted at a later
        ``step()`` when a slot frees; capacity-checked as in generate()."""
        cb = self.cb
        toks = cb.tokenizer.encode(prompt, bos=True, eos=False)
        cb._check_capacity(toks, max_gen_len, image, prefix)
        rid = self._next_id
        self._next_id += 1
        self._toks[rid] = toks
        self._images[rid] = image
        self._prefixes[rid] = prefix
        self.gen_lims[rid] = int(max_gen_len)
        self.out_tokens[rid] = []
        self._arrival[rid] = time.perf_counter()
        self.queue.append(rid)
        return rid

    @torch.inference_mode()
    def step(self) -> int:
        """Admit what fits, advance one round; returns the work left
        (active slots + queued requests), 0 when idle."""
        cb = self.cb
        pairs = []
        for slot in range(cb.slots):
            if cb._active[slot] is None and self.queue:
                rid = self.queue.popleft()
                pairs.append((slot, rid, self._toks[rid],
                              self._images.pop(rid, None),
                              self._prefixes.pop(rid, None)))
        if pairs:
            cb._admit_pairs(pairs, self.out_tokens, self.gen_lims,
                            self.stops)
        if any(a is not None for a in cb._active):
            if cb.draft_k:
                cb._speculative_round(self.out_tokens, self.gen_lims,
                                      self.stops, self.stop_syms)
            else:
                cb._decode_round(self.out_tokens, self.gen_lims, self.stops,
                                 self.stop_syms)
        return sum(a is not None for a in cb._active) + len(self.queue)

    def poll(self, rid: int) -> dict:
        """One request so far: ``done``, the raw ``tokens`` and the
        ``text`` with stop tokens and strings cut as generate() cuts."""
        toks = list(self.out_tokens.get(rid, ()))
        return {
            "done": rid in self.cb._finish_t,
            "tokens": toks,
            "text": _text(self.cb.tokenizer, toks, self.stops,
                          self.stop_syms),
        }

    def drain(self) -> None:
        while self.step():
            pass

    def stats(self) -> dict:
        """Latency over everything finished so far, TTFT from SUBMIT
        (arrival) time; the schema of ``ContinuousBatcher.last_stats``."""
        cb = self.cb
        per = []
        for rid, fin in cb._finish_t.items():
            adm = cb._admit_t[rid]
            n = len(self.out_tokens[rid])
            per.append({
                "tokens": n,
                "ttft_s": adm - self._arrival[rid],
                "tpot_ms": (1e3 * max(fin - adm, 0.0) / (n - 1)
                            if n > 1 else 0.0),
            })
        if not per:
            return {"requests": 0}
        t0 = min(self._arrival.values())
        return _summary(per, max(cb._finish_t.values()) - t0)
