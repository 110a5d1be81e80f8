"""MetaModel for ``llama_type="llama_ens5"`` (counterpart of
a3vlm_tpu/meta.py): parameters, tokenizer, checkpoint loading
(``from_pretrained``), quantization, LoRA adapters served unmerged, image
encoding, generation (batched and streamed), the scoring APIs and the
training loss.

Without a tokenizer the model is driven with token ids
(``generate_tokens``); with one, ``generate`` takes and returns text."""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from a3vlm_tpu_torch.config import (
    Ens5Config,
    ModelArgs,
    model_args_from_json,
    probe_pretrained_dir,
)
from a3vlm_tpu_torch.generation import Generator, synchronize
from a3vlm_tpu_torch.models import ens5 as ens5_mod
from a3vlm_tpu_torch.models import llama as llama_mod
from a3vlm_tpu_torch.quant import quantize_params
from a3vlm_tpu_torch.train.losses import next_token_loss

_UNPORTED_TYPE = ("{} is not ported yet (ROADMAP Queue 1 item 15: the "
                  "other model families)")


class MetaModel:
    def __init__(
        self,
        llama_type: str = "llama_ens5",
        llama_config: Optional[Sequence[str]] = None,
        tokenizer_path: Optional[str] = None,
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
        """As the JAX constructor (meta.py:37-170) for llama_ens5. The
        tokenizer is ``tokenizer``, or loaded from ``tokenizer_path``; the
        true vocab comes from its ``n_words``, or from ``vocab_size`` when
        there is no tokenizer, and is padded to ``vocab_align``.
        ``llama_config`` (JSON files, later ones win) sets the decoder when
        ``model_cfg`` is not given. With ``params=None`` random weights are
        made from ``seed`` on ``device``: the card, unless the caller names
        another."""
        if llama_type != "llama_ens5":
            raise NotImplementedError(_UNPORTED_TYPE.format(llama_type))
        self.llama_type = llama_type
        self.with_visual = with_visual
        if tokenizer is None and tokenizer_path is not None:
            from a3vlm_tpu_torch.tokenizer import Tokenizer

            tokenizer = Tokenizer(tokenizer_path)
        self.tokenizer = tokenizer
        if tokenizer is not None:
            self.true_vocab = tokenizer.n_words
        elif vocab_size is not None:
            self.true_vocab = vocab_size
        else:
            raise ValueError("pass a tokenizer, tokenizer_path or vocab_size")
        align = max(128, vocab_align)
        padded_vocab = -(-self.true_vocab // align) * align
        if model_cfg is None:
            overrides = dict(max_seq_len=max_seq_len, vocab_size=padded_vocab)
            args = (model_args_from_json(llama_config, **overrides)
                    if llama_config else ModelArgs(**overrides))
            model_cfg = Ens5Config(llama=args)
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
        self._loras: list = []  # adapters served unmerged (load_lora)
        self._generator: Optional[Generator] = None
        self._kv_cache_bits: Optional[int] = None
        self._prefill_chunk: Optional[int] = None
        # wall times (ms) of the last generate call, synchronized on CUDA
        self.last_stats: dict = {}
        # emitted tokens and verify rounds of the last draft_k request
        self.last_spec_stats: Optional[dict] = None

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        pretrained_path: str | List[str],
        llama_type: Optional[str] = None,
        llama_config: Optional[Sequence[str]] = None,
        tokenizer_path: Optional[str] = None,
        with_visual: bool = False,
        max_seq_len: int = 4096,
        dtype: torch.dtype = torch.bfloat16,
        quant: bool = False,
        vocab_align: int = 128,
        device: torch.device | str = "cuda",
        tokenizer=None,
    ) -> "MetaModel":
        """(meta.py:175-273). Probes meta.json (llama_type), config.json
        (llama_config) and the tokenizer under ``pretrained_path`` (or takes
        ``tokenizer``); loads the consolidated checkpoints in order, a diff
        checkpoint adding onto the base before it. The state dict is read
        and imported as numpy on the host, then lands on ``device`` once:
        a checkpoint with the towers makes no random weights at all; one
        with the decoder alone keeps the random towers and drops the random
        decoder before the loaded one lands."""
        from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
        from a3vlm_tpu_torch.checkpoint.ens5_import import (
            has_ens5_towers,
            import_ens5_consolidated,
        )
        from a3vlm_tpu_torch.checkpoint.torch_import import (
            apply_diff_checkpoint,
            import_llama_consolidated,
            load_consolidated_dir,
        )
        from a3vlm_tpu_torch.tokenizer import (
            probe_tokenizer_path_from_pretrained,
        )

        paths = ([pretrained_path] if isinstance(pretrained_path, str)
                 else list(pretrained_path))
        probed = probe_pretrained_dir(paths[-1])
        llama_type = llama_type or probed.get("llama_type") or "llama"
        if llama_type != "llama_ens5":
            raise NotImplementedError(_UNPORTED_TYPE.format(llama_type))
        if llama_config is None and "llama_config" in probed:
            cfg_file = Path(paths[-1]) / "config.json"
            llama_config = [str(cfg_file)] if cfg_file.exists() else None
        if tokenizer is None and tokenizer_path is None:
            for p in paths[::-1]:
                tokenizer_path = probe_tokenizer_path_from_pretrained(p)
                if tokenizer_path is not None:
                    break
            if tokenizer_path is None:
                raise FileNotFoundError(
                    f"no tokenizer found under {paths}; pass tokenizer_path")

        merged = None
        for p in paths:
            sd, fmt = load_consolidated_dir(p)
            if fmt == "diff" and merged is not None:
                merged = apply_diff_checkpoint(merged, sd)
            else:
                merged = sd
        towers = bool(merged) and has_ens5_towers(merged)
        model = cls(
            llama_type=llama_type, llama_config=llama_config,
            tokenizer_path=tokenizer_path, with_visual=with_visual,
            max_seq_len=max_seq_len, dtype=dtype,
            params={} if towers else None, tokenizer=tokenizer,
            vocab_align=vocab_align, device=device,
        )
        if merged:
            if towers:
                # the full released checkpoint: decoder, the four tower
                # trees, projectors and tags in one state dict
                tree = import_ens5_consolidated(merged, model.cfg)
            else:
                tree = {"llama": import_llama_consolidated(
                    merged, n_layers=model.args.n_layers)}
                # projectors and image tags, when present in the checkpoint
                tree.update(_import_ens5_extras(merged))
                for k in tree:  # free the random leaves before these land
                    model.params[k] = None
                gc.collect()
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
            del merged
            model.params.update(params_from_numpy(tree, device=device,
                                                  dtype=dtype))
            model._pad_vocab_entries()
        if quant:
            model.quantize()
        return model

    def _pad_vocab_entries(self) -> None:
        """Zero-pad imported embedding rows / lm-head columns up to the
        config's padded vocab (meta.py:275). Checkpoints carry the true
        vocab; every logits consumer masks the tail with ``true_vocab``."""
        V = self.args.vocab_size
        tree = self.params["llama"]
        emb = tree["tok_embeddings"]["weight"]
        if emb.shape[0] < V:
            tree["tok_embeddings"]["weight"] = torch.nn.functional.pad(
                emb, (0, 0, 0, V - emb.shape[0]))
        head = tree["output"]["weight"]
        if head.shape[-1] < V:
            tree["output"]["weight"] = torch.nn.functional.pad(
                head, (0, V - head.shape[-1]))

    def quantize(self, bits: Optional[int] = 4,
                 tower_bits: Optional[int] = None) -> None:
        """Weight-only quantization (meta.py:302). ``bits`` 4 or 8
        quantizes the decoder (None leaves it); projectors stay dense.
        ``tower_bits=8`` makes the four vision towers' linears per-channel
        int8, which sends them through ``w8a8_matmul`` (the activations
        round to int8 there: opt-in). In place, leaf by leaf; attached
        adapters are dropped, as the JAX method resets its transform. The
        JAX method's ``tp_align`` and ``row_parallel`` are for several
        devices and have no counterpart."""
        if bits:
            quantize_params(self.params["llama"], bits=bits)
        if tower_bits:
            if tower_bits != 8:
                raise ValueError("towers support W8A8 only: tower_bits=8")
            ens5_mod.quantize_tower_params(self.params)
        self._loras = []
        self._generator = None

    def load_lora(self, lora_tree: dict) -> None:
        """Attach trained LoRA adapters for serving WITHOUT merging
        (meta.py:353): every targeted decoder linear runs
        ``qmat(x, base) + (x @ a) @ b`` (``quant.LoraWeight``), exact on
        packed bases. ``lora_tree`` is the port's adapter tree
        (``{"layers": [per-layer {group: {name: {"a", "b"}}}]}``, as
        ``train.lora.init_lora_params`` makes it; a JAX tree goes through
        ``params_from_numpy``). Adapters wider than the base (trained
        against a padded base) are sliced to fit. Call after
        ``quantize()``, which drops them."""
        from a3vlm_tpu_torch.train.lora import fit_lora_to

        fitted = fit_lora_to(self.params["llama"], lora_tree)
        self._loras.append(fitted)
        self._generator = None

    def load_adapter_checkpoint(self, ckpt_dir: str,
                                merge: bool = False) -> None:
        """Consume a trainable-only train checkpoint of the port
        (``--only_save_trainable`` from a ``--lora_rank`` / ``--quant``
        run; meta.py:381): the dense trainables it holds (norms, biases,
        projectors, image tags) replace the current leaves of the same
        path and shape, in the current leaf's dtype and device, and the
        adapters are served unmerged (``load_lora``) or, with
        ``merge=True``, folded into the dense decoder weights
        (``merge_lora``; a packed base refuses)."""
        from a3vlm_tpu_torch.checkpoint.bridge import params_from_host
        from a3vlm_tpu_torch.checkpoint.manager import restore_raw_checkpoint
        from a3vlm_tpu_torch.train.lora import fit_lora_to, merge_lora

        raw = params_from_host(restore_raw_checkpoint(ckpt_dir),
                               device=self.device)
        lora_tree = raw.pop("lora", None)
        self.params = _overlay(self.params, raw)
        if lora_tree is not None:
            if merge:
                decoder = self.params["llama"]
                self.params = {**self.params, "llama": merge_lora(
                    decoder, fit_lora_to(decoder, lora_tree))}
            else:
                self.load_lora(lora_tree)
        self._generator = None

    # -- API ----------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.params["llama"]["norm"]["weight"].device

    def _decoder_params(self) -> dict:
        """The decoder with every loaded adapter attached (meta.py:454)."""
        from a3vlm_tpu_torch.train.lora import attach_lora

        p = self.params["llama"]
        for lora in self._loras:
            p = attach_lora(p, lora)
        return p

    @torch.inference_mode()
    def encode_images(self, images, impl: str = "auto"
                      ) -> Optional[torch.Tensor]:
        """NHWC CLIP-normalized images -> image tokens (meta.py:429). A
        numpy batch goes to the model's device in the towers' dtype."""
        if images is None:
            return None
        if not isinstance(images, torch.Tensor):
            images = torch.as_tensor(np.asarray(images), device=self.device,
                                     dtype=self.params["start_img"].dtype)
        return ens5_mod.build_image_tokens(self.params, self.cfg, images,
                                           impl)

    def get_image_words(self) -> int:
        return self.image_words

    def get_quant_blocklist(self) -> list[str]:
        """Subtrees left dense by ``quantize`` (meta.py:715)."""
        return list(ens5_mod.quant_blocklist())

    def get_trainable_params(self) -> dict:
        """The trainable mask (meta.py:720): towers frozen."""
        return ens5_mod.trainable_mask(self.params)

    def forward(self, examples: torch.Tensor, labels: torch.Tensor,
                images: Optional[torch.Tensor] = None,
                impl: str = "auto") -> torch.Tensor:
        """Training loss (meta.py:464): next-token cross-entropy of the
        text positions, label 0 ignored, padded vocab masked."""
        params = {**self.params, "llama": self._decoder_params()}
        logits = ens5_mod.forward(params, self.cfg, examples, image=images,
                                  impl=impl)
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
                self._decoder_params(), self.args, self.tokenizer,
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
        t0 = time.perf_counter()
        image_tokens = self.encode_images(images, impl)
        synchronize(self.device)
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

    @torch.inference_mode()
    def stream_generate(
        self,
        prompt: str,
        image=None,
        max_gen_len: int = 512,
        temperature: float = 0.0,
        top_p: float = 0.95,
        additional_stop_symbols: Iterable[str] = (),
        seed: int = 0,
        impl: str = "auto",
    ):
        """Single-prompt streaming generation (meta.py:568): yields
        {"text", "end_of_content"} dicts, one a token, over
        ``llama.prefill`` of the whole prompt and one ``llama.decode_step``
        a token. Sampling draws from a ``torch.Generator`` seeded with
        ``seed`` (the JAX method's key chain differs: sampled text agrees by
        distribution only)."""
        from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype
        from a3vlm_tpu_torch.ops.sampling import sample_token

        if image is not None and np.ndim(image) == 3:
            image = image[None]
        image_tokens = self.encode_images(image, impl)
        tok, args, device = self.tokenizer, self.args, self.device
        max_seq_len = args.max_seq_len - (
            self.image_words if image_tokens is not None else 0)
        prompt_tokens = tok.encode(prompt, bos=True, eos=False)
        prompt_tokens = prompt_tokens[-(max_seq_len - max_gen_len):]
        total_len = min(max_seq_len, max_gen_len + len(prompt_tokens))

        params = self._decoder_params()
        W = 0 if image_tokens is None else image_tokens.shape[1]
        cache = llama_mod.KVCache.create(
            args, 1, total_len + W,
            dtype=kv_cache_dtype(self.kv_cache_bits, device), device=device)
        logits, cache, _ = llama_mod.prefill(
            params, args, cache, torch.tensor([prompt_tokens], device=device),
            image_tokens, impl)
        gen = (torch.Generator(device=device).manual_seed(seed)
               if temperature > 0 else None)
        generated: list[int] = []
        for cur_pos in range(len(prompt_tokens), total_len):
            next_token = int(sample_token(logits[:, : self.true_vocab],
                                          temperature, top_p, gen)[0])
            if next_token == tok.eos_id:
                break
            generated.append(next_token)
            text = tok.decode(generated)
            for stop_symbol in additional_stop_symbols:
                stop_pos = text.find(stop_symbol)
                if stop_pos != -1:
                    yield {"text": text[:stop_pos], "end_of_content": True}
                    return
            yield {"text": text, "end_of_content": False}
            logits, cache = llama_mod.decode_step(
                params, args, cache,
                torch.tensor([[next_token]], device=device), cur_pos + W,
                impl)
        yield {"text": tok.decode(generated), "end_of_content": True}

    @torch.inference_mode()
    def compute_logits(self, examples: List, images=None, bos: bool = True,
                       eos: bool = False, impl: str = "auto"
                       ) -> List[np.ndarray]:
        """(meta.py:635): right-padded batch forward; per-item float32
        logits over the true vocab, trimmed to each item's length."""
        if isinstance(examples, str):
            raise ValueError("compute_logits expects a batched LIST")
        if isinstance(examples[0], str):
            examples = [self.tokenizer.encode(e, bos, eos) for e in examples]
        lens = [len(e) for e in examples]
        toks = torch.zeros((len(examples), max(lens)), dtype=torch.int64)
        for i, e in enumerate(examples):
            toks[i, : len(e)] = torch.tensor(e)
        image_tokens = self.encode_images(images, impl)
        logits = llama_mod.forward_train(
            self._decoder_params(), self.args, toks.to(self.device),
            image_tokens=image_tokens, impl=impl)
        logits = logits.float()[..., : self.true_vocab].cpu().numpy()
        return [lg[:n] for lg, n in zip(logits, lens)]

    def evaluate_examples(self, examples: List,
                          contexts: Optional[List] = None, images=None,
                          bos: bool = True, eos: bool = False) -> dict:
        """(meta.py:666): per-example log-likelihood, mean loss ("ppl") and
        greedy match over the non-context suffix."""
        if isinstance(examples, str):
            raise ValueError("evaluate_examples expects a batched LIST")
        if isinstance(examples[0], str):
            examples = [self.tokenizer.encode(e, bos, eos) for e in examples]
            if contexts is not None:
                contexts = [self.tokenizer.encode(c, bos, False)
                            for c in contexts]
        if contexts is not None and not all(
                e[: len(c)] == c for e, c in zip(examples, contexts)):
            raise ValueError("each context must be a prefix of its example")

        logits = self.compute_logits(examples, images)
        result = {"log_likelihood": [], "ppl": [], "max_equal": [],
                  "non_context_logits": []}
        for idx, item_logits in enumerate(logits):
            start = 0 if contexts is None else len(contexts[idx]) - 1
            if start < 0:
                raise ValueError("an empty context has no last token")
            item_logits = item_logits[start:-1]
            labels = np.asarray(examples[idx][start + 1:])
            logp = torch.log_softmax(torch.from_numpy(item_logits), dim=-1)
            token_ll = torch.gather(
                logp, 1, torch.from_numpy(labels)[:, None].long())[:, 0]
            token_ll = token_ll.numpy()
            valid = labels != 0
            losses = np.where(valid, -token_ll, 0.0)
            n = max(int(valid.sum()), 1)
            result["log_likelihood"].append(float(-losses.sum()))
            result["ppl"].append(float(losses.sum() / n))
            result["max_equal"].append(
                bool((item_logits.argmax(-1) == labels).all()))
            result["non_context_logits"].append(item_logits)
        return result


def _overlay(base, new):
    """``new``'s leaves over ``base`` where path and shape agree, cast to
    the base leaf's dtype; everything else keeps the base (meta.py:394)."""
    if new is None:
        return base
    if isinstance(base, dict) and isinstance(new, dict):
        return {k: _overlay(v, new[k]) if k in new else v
                for k, v in base.items()}
    if isinstance(base, list) and isinstance(new, list):
        return [_overlay(b, n) for b, n in zip(base, new)] + base[len(new):]
    if (isinstance(base, torch.Tensor) and isinstance(new, torch.Tensor)
            and base.shape == new.shape):
        return new.to(base.dtype)
    return base


def _import_ens5_extras(sd) -> dict:
    """Projector / image-tag weights from a consolidated ens5 state dict
    (meta.py:726; llama_ens5.py:325-339 module names), as numpy."""
    out: dict = {}
    for name in ("qformer_proj", "visual_proj"):
        wk = f"llma.{name}.0.weight"
        if wk in sd:
            out[name] = {
                "linear": {
                    "weight": np.asarray(sd[wk]).T,
                    "bias": np.asarray(sd[f"llma.{name}.0.bias"]),
                },
                "ln": {
                    "weight": np.asarray(sd[f"llma.{name}.1.weight"]),
                    "bias": np.asarray(sd[f"llma.{name}.1.bias"]),
                },
            }
    for tag in ("start_img", "end_img", "start_depth_img", "end_depth_img"):
        if f"llma.{tag}" in sd:
            out[tag] = np.asarray(sd[f"llma.{tag}"])
    return out
