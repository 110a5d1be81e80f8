"""MetaModel for ``llama_type="llama_ens5"`` (counterpart of
a3vlm_tpu/meta.py): parameters, optional tokenizer, quantization,
image encoding, generation and the training loss.

Without a tokenizer the model is driven with token ids
(``generate_tokens``); with one, ``generate`` takes and returns text."""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Sequence

import torch

from a3vlm_tpu_torch.config import Ens5Config, ModelArgs
from a3vlm_tpu_torch.generation import Generator, synchronize
from a3vlm_tpu_torch.models import ens5 as ens5_mod
from a3vlm_tpu_torch.quant import quantize_params
from a3vlm_tpu_torch.train.losses import next_token_loss


class MetaModel:
    def __init__(
        self,
        llama_type: str = "llama_ens5",
        with_visual: bool = False,
        max_seq_len: int = 2048,
        dtype: torch.dtype = torch.float32,
        params: Optional[dict] = None,
        tokenizer=None,
        vocab_size: Optional[int] = None,
        seed: int = 0,
        model_cfg: Optional[Ens5Config] = None,
        vocab_align: int = 128,
        device: torch.device | str = "cuda",
    ):
        """As the JAX constructor (meta.py:37-170) for llama_ens5. The true
        vocab comes from ``tokenizer.n_words``, or from ``vocab_size`` when
        no tokenizer is given, and is padded to ``vocab_align``. With
        ``params=None`` random weights are made from ``seed`` on
        ``device``: the card, unless the caller names another."""
        if llama_type != "llama_ens5":
            raise NotImplementedError(f"{llama_type} is not ported yet")
        self.llama_type = llama_type
        self.with_visual = with_visual
        self.tokenizer = tokenizer
        if tokenizer is not None:
            self.true_vocab = tokenizer.n_words
        elif vocab_size is not None:
            self.true_vocab = vocab_size
        else:
            raise ValueError("pass a tokenizer or vocab_size")
        align = max(128, vocab_align)
        padded_vocab = -(-self.true_vocab // align) * align
        if model_cfg is None:
            model_cfg = Ens5Config(llama=ModelArgs(max_seq_len=max_seq_len,
                                                   vocab_size=padded_vocab))
        if model_cfg.llama.vocab_size != padded_vocab:
            model_cfg = dataclasses.replace(
                model_cfg,
                llama=model_cfg.llama.replace(vocab_size=padded_vocab))
        self.cfg = model_cfg
        self.args = model_cfg.llama
        self.image_words = model_cfg.image_words if with_visual else 0
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = ens5_mod.init_ens5_params(model_cfg, dtype, device, gen)
        self.params = params
        self._generator: Optional[Generator] = None
        self._kv_cache_bits: Optional[int] = None
        self._prefill_chunk: Optional[int] = None
        # wall times (ms) of the last generate call, synchronized on CUDA
        self.last_stats: dict = {}
        # emitted tokens and verify rounds of the last draft_k request
        self.last_spec_stats: Optional[dict] = None

    def quantize(self, bits: Optional[int] = 4,
                 tower_bits: Optional[int] = None) -> None:
        """Weight-only quantization (meta.py:302). ``bits`` 4 or 8
        quantizes the decoder (None leaves it); projectors stay dense.
        ``tower_bits=8`` makes the four vision towers' linears per-channel
        int8, which sends them through ``w8a8_matmul`` (the activations
        round to int8 there: opt-in). In place, leaf by leaf. The JAX
        method's ``tp_align`` and ``row_parallel`` are for several devices
        and have no counterpart."""
        if bits:
            quantize_params(self.params["llama"], bits=bits)
        if tower_bits:
            if tower_bits != 8:
                raise ValueError("towers support W8A8 only: tower_bits=8")
            ens5_mod.quantize_tower_params(self.params)
        self._generator = None

    @torch.inference_mode()
    def encode_images(self, images: Optional[torch.Tensor],
                      impl: str = "auto") -> Optional[torch.Tensor]:
        """NHWC CLIP-normalized images -> image tokens (meta.py:429)."""
        if images is None:
            return None
        return ens5_mod.build_image_tokens(self.params, self.cfg, images,
                                           impl)

    def get_image_words(self) -> int:
        return self.image_words

    def get_trainable_params(self) -> dict:
        """The trainable mask (meta.py:720): towers frozen."""
        return ens5_mod.trainable_mask(self.params)

    def forward(self, examples: torch.Tensor, labels: torch.Tensor,
                images: Optional[torch.Tensor] = None,
                impl: str = "auto") -> torch.Tensor:
        """Training loss (meta.py:464): next-token cross-entropy of the
        text positions, label 0 ignored, padded vocab masked."""
        logits = ens5_mod.forward(self.params, self.cfg, examples,
                                  image=images, impl=impl)
        return next_token_loss(logits, labels, vocab_size=self.true_vocab)

    @property
    def kv_cache_bits(self) -> Optional[int]:
        """8 -> int8 KV cache (meta.py:487). Setting it drops the cached
        Generator, so the change takes effect on the next generate call."""
        return self._kv_cache_bits

    @kv_cache_bits.setter
    def kv_cache_bits(self, value: Optional[int]) -> None:
        if value not in (None, 8):
            raise ValueError(f"kv_cache_bits {value}: want None or 8")
        if value != self._kv_cache_bits:
            self._kv_cache_bits = value
            self._generator = None

    @property
    def prefill_chunk(self) -> Optional[int]:
        """Chunk length of the memory-bounded prefill
        (``llama.prefill_chunked``; meta.py:501), None for one piece. Same
        invalidation as ``kv_cache_bits``."""
        return self._prefill_chunk

    @prefill_chunk.setter
    def prefill_chunk(self, value: Optional[int]) -> None:
        if value != self._prefill_chunk:
            self._prefill_chunk = value
            self._generator = None

    def _get_generator(self) -> Generator:
        if self._generator is None:
            self._generator = Generator(
                self.params["llama"], self.args, self.tokenizer,
                image_words=self.image_words, vocab_limit=self.true_vocab,
                kv_cache_bits=self._kv_cache_bits,
                prefill_chunk=self._prefill_chunk,
            )
        return self._generator

    def generate_tokens(
        self,
        prompt_tokens: Sequence[Sequence[int]],
        images: Optional[torch.Tensor] = None,
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
        """Token ids in (BOS included), generated ids out; the entry that
        needs no tokenizer. The default stop is LLaMA's EOS id 2. ``fsm``
        masks every generated token to a grammar; ``draft_k`` sends a
        batch-1 request through prompt-lookup speculative decoding
        (``Generator.generate_tokens``)."""
        return self._timed(images, impl, lambda gen, tokens: (
            gen.generate_tokens(
                prompt_tokens, image_tokens=tokens, max_gen_len=max_gen_len,
                temperature=temperature, top_p=top_p, stop_tokens=stop_tokens,
                seed=seed, impl=impl, fsm=fsm, draft_k=draft_k,
                lookup_max_n=lookup_max_n)))

    def _timed(self, images, impl: str, run):
        """The path both entries share: the towers timed on the device,
        then ``run(generator, image_tokens)``; sets ``last_stats`` (towers,
        prefill and decode) and ``last_spec_stats`` of this call."""
        gen = self._get_generator()
        device = self.params["llama"]["norm"]["weight"].device
        t0 = time.perf_counter()
        image_tokens = self.encode_images(images, impl)
        synchronize(device)
        towers_ms = (time.perf_counter() - t0) * 1e3
        out = run(gen, image_tokens)
        self.last_stats = {"towers_ms": towers_ms, **gen.last_stats}
        self.last_spec_stats = gen.last_spec_stats
        return out

    def generate(
        self,
        prompts: list[str],
        images: Optional[torch.Tensor] = None,
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
        """Text prompts in, text out (meta.py:540); needs a tokenizer."""
        if self.tokenizer is None:
            raise ValueError("generate needs a tokenizer; use generate_tokens")
        return self._timed(images, impl, lambda gen, tokens: gen.generate(
            prompts, image_tokens=tokens, max_gen_len=max_gen_len,
            temperature=temperature, top_p=top_p,
            additional_stop_symbols=additional_stop_symbols, seed=seed,
            impl=impl, fsm=fsm, draft_k=draft_k, lookup_max_n=lookup_max_n))
