"""MetaModel (counterpart of a3vlm_tpu/meta.py) for the families
``llama_ens5``, ``llama_ens5_2images`` (RGB + depth), the released 7B's
``internlm_ems5_light``, the text-only ``llama`` and the text-only
``falcon``: parameters, tokenizer, checkpoint loading
(``from_pretrained``; not for ``falcon``, whose JAX loader fails),
quantization, LoRA adapters served unmerged, image encoding, generation
(batched and streamed), the scoring APIs and the training loss.

Without a tokenizer the model is driven with token ids
(``generate_tokens``); with one, ``generate`` takes and returns text."""

from __future__ import annotations

import dataclasses
import gc
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from a3vlm_tpu_torch.config import (
    Ens5Config,
    ModelArgs,
    load_config_union,
    model_args_from_json,
    probe_pretrained_dir,
)
from a3vlm_tpu_torch.generation import (
    FALCON_GEN_OPS,
    LLAMA_GEN_OPS,
    Generator,
    decoder_device,
    synchronize,
)
from a3vlm_tpu_torch.models import ens5 as ens5_mod
from a3vlm_tpu_torch.models import ens5_2images as e2_mod
from a3vlm_tpu_torch.models import falcon as falcon_mod
from a3vlm_tpu_torch.models import internlm_ems5_light as il_mod
from a3vlm_tpu_torch.models import llama as llama_mod
from a3vlm_tpu_torch.parallel import tp
from a3vlm_tpu_torch.parallel.mesh import (
    current_mesh,
    is_parallel,
    on_mesh,
    use_mesh,
)
from a3vlm_tpu_torch.quant import quantize_params, tree_map
from a3vlm_tpu_torch.train.losses import next_token_loss
from a3vlm_tpu_torch.utils import trace

# the families of the port: the module of each and its random init
_FAMILY = {"llama": llama_mod, "llama_ens5": ens5_mod,
           "llama_ens5_2images": e2_mod, "internlm_ems5_light": il_mod,
           "falcon": falcon_mod}
_INIT = {"llama": llama_mod.init_llama_params,
         "llama_ens5": ens5_mod.init_ens5_params,
         "llama_ens5_2images": e2_mod.init_params,
         "internlm_ems5_light": il_mod.init_params,
         "falcon": falcon_mod.init_falcon_params}
FAMILIES = tuple(_FAMILY)
# the families whose whole tree is the decoder (no towers)
_BARE = ("llama", "falcon")


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
        model_cfg=None,
        vocab_align: int = 128,
        device: torch.device | str = "cuda",
    ):
        """As the JAX constructor (meta.py:37-170), for ``llama_type``
        ``llama`` (a bare decoder, text only), ``llama_ens5``,
        ``llama_ens5_2images`` (RGB + depth, twice the image words),
        ``internlm_ems5_light`` (``InternlmEns5Config``) and ``falcon`` (a
        bare text-only decoder, ``FalconArgs``; ``llama_config``'s fields
        over ``FalconArgs()``). The tokenizer is
        ``tokenizer``, or loaded from ``tokenizer_path``; the true vocab
        comes from its ``n_words``, or from ``vocab_size`` when there is no
        tokenizer, and is padded to ``vocab_align``. ``llama_config`` (JSON
        files, later ones win) sets the decoder when ``model_cfg`` is not
        given: over ``ModelArgs()`` with ``max_seq_len``, or, for
        ``internlm_ems5_light``, over InternLM2-7B's args, whose
        ``max_seq_len`` the caller's does not change (the JAX constructor
        reads neither there). With ``params=None`` random weights are made
        from ``seed`` on ``device``: the card, unless the caller names
        another."""
        if llama_type not in FAMILIES:
            raise KeyError(f"unknown llama_type: {llama_type}")
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
        self._mod = _FAMILY[llama_type]
        if model_cfg is None:
            model_cfg = _default_config(llama_type, llama_config,
                                        max_seq_len)
        if llama_type == "falcon":
            # (meta.py:81-112) the vocab and max_seq_len replace those of
            # any config, model_cfg's too
            model_cfg = dataclasses.replace(
                model_cfg, vocab_size=padded_vocab, max_seq_len=max_seq_len)
            self.args = model_cfg
            self.image_words = 0
        elif llama_type == "llama":
            model_cfg = model_cfg.replace(vocab_size=padded_vocab)
            self.args = model_cfg
            self.image_words = 0
        else:
            if model_cfg.llama.vocab_size != padded_vocab:
                model_cfg = dataclasses.replace(
                    model_cfg,
                    llama=model_cfg.llama.replace(vocab_size=padded_vocab))
            self.args = model_cfg.llama
            self.image_words = model_cfg.image_words if with_visual else 0
            if llama_type == "llama_ens5_2images":
                self.image_words *= 2  # RGB + depth (meta.py:136)
        self.cfg = model_cfg
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = _INIT[llama_type](model_cfg, dtype, device, gen)
        self.params = params
        # the mesh whose shard of the weights ``params`` holds (set by
        # ModelServer or a caller running the model on several ranks)
        self.mesh = None
        self._loras: list = []  # adapters served unmerged (load_lora)
        self._generator: Optional[Generator] = None
        self._kv_cache_bits: Optional[int] = None
        self._prefill_chunk: Optional[int] = None
        # the numbers (ms on the host unless named otherwise, synchronised
        # where a phase ends; step and row-step counts) and the spans of
        # the last generate call (``utils/trace.py``)
        self.last_stats: dict = {}
        self.last_trace: Optional[trace.Record] = None
        # emitted tokens and verify rounds of the last draft_k request
        self.last_spec_stats: Optional[dict] = None

    def __getstate__(self) -> dict:
        """Pickled for another rank: the family's module goes by name, the
        cached generator and the mesh (a process's own) stay behind."""
        state = dict(self.__dict__)
        del state["_mod"]
        state.update(_generator=None, mesh=None)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._mod = _FAMILY[self.llama_type]

    @property
    def decoder(self) -> dict:
        """The decoder's tree: the whole tree of a ``llama`` or ``falcon``
        model, the ``"llama"`` subtree of the others."""
        return self.params if self.llama_type in _BARE else \
            self.params["llama"]

    def _set_decoder(self, tree: dict) -> None:
        if self.llama_type in _BARE:
            self.params = tree
        else:
            self.params = {**self.params, "llama": tree}

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
        and imported as numpy on the host, then lands on ``device`` once.
        Three routes, as the JAX method's: an ens5 checkpoint with the
        towers (``llama_ens5``, ``llama_ens5_2images``) replaces the whole
        tree and makes no random weights at all; a ``llama`` checkpoint is
        the whole tree, its decoder; any other keeps the random towers
        (``internlm_ems5_light``'s DINOv2 and ConvNeXt are never imported)
        and takes the decoder, the projectors and the image tags the
        checkpoint holds, the random ones dropped before these land."""
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
        if llama_type == "falcon":
            # the JAX loader builds the model, reads the checkpoint, then
            # fails importing it with LLaMA's importer, which reads
            # ``n_layers`` that FalconArgs lacks (meta.py:254-259)
            raise ValueError("from_pretrained does not load llama_type "
                             "falcon: the JAX package has no falcon "
                             "checkpoint importer")
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
        whole = bool(merged) and (
            llama_type == "llama" or (llama_type.startswith("llama_ens5")
                                      and has_ens5_towers(merged)))
        model = cls(
            llama_type=llama_type, llama_config=llama_config,
            tokenizer_path=tokenizer_path, with_visual=with_visual,
            max_seq_len=max_seq_len, dtype=dtype,
            params={} if whole else None, tokenizer=tokenizer,
            vocab_align=vocab_align, device=device,
        )
        if merged:
            n_layers = model.args.n_layers
            if llama_type == "llama":
                tree = import_llama_consolidated(merged, n_layers=n_layers)
            elif whole:
                # the full released checkpoint: decoder, the four tower
                # trees, projectors and tags in one state dict
                tree = import_ens5_consolidated(merged, model.cfg)
            else:
                tree = {"llama": import_llama_consolidated(
                    merged, n_layers=n_layers)}
                # projectors and image tags, when present in the checkpoint
                tree.update(_import_ens5_extras(merged))
                for k in tree:  # free the random leaves before these land
                    model.params[k] = None
                gc.collect()
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
            del merged
            tree = params_from_numpy(tree, device=device, dtype=dtype)
            if llama_type == "llama":
                model.params = tree
            else:
                model.params.update(tree)
            model._pad_vocab_entries()
        if quant:
            model.quantize()
        return model

    def _pad_vocab_entries(self) -> None:
        """Zero-pad imported embedding rows / lm-head columns up to the
        config's padded vocab (meta.py:275). Checkpoints carry the true
        vocab; every logits consumer masks the tail with ``true_vocab``."""
        V = self.args.vocab_size
        tree = self.decoder
        key = ("word_embeddings" if self.llama_type == "falcon"
               else "tok_embeddings")
        emb = tree[key]["weight"]
        if emb.shape[0] < V:
            tree[key]["weight"] = torch.nn.functional.pad(
                emb, (0, 0, 0, V - emb.shape[0]))
        head = tree["output"]["weight"]
        if head.shape[-1] < V:
            tree["output"]["weight"] = torch.nn.functional.pad(
                head, (0, V - head.shape[-1]))

    def quantize(self, bits: Optional[int] = 4, tp_align: int = 0,
                 row_parallel: int = 0,
                 tower_bits: Optional[int] = None) -> None:
        """Weight-only quantization (meta.py:302). ``bits`` 4 or 8
        quantizes the decoder (None leaves it); projectors stay dense.
        ``tp_align`` (model_parallel_size * 128) pads the ffn hidden dim so
        the gate / up shards stay lane-aligned; ``row_parallel``
        (model_parallel_size) chunk-packs wo / w2 so they split by rows
        (``quant.quantize_params``).
        ``tower_bits=8`` makes the four vision towers' linears per-channel
        int8, which sends them through ``w8a8_matmul`` (the activations
        round to int8 there: opt-in). In place, leaf by leaf; attached
        adapters are dropped, as the JAX method resets its transform. A
        ``llama`` or ``falcon`` model has no towers and ignores
        ``tower_bits``, as the JAX method does; ``internlm_ems5_light``'s
        DINOv2 and ConvNeXt take it."""
        if bits:
            quantize_params(self.decoder, bits=bits, tp_align=tp_align,
                            row_parallel=row_parallel)
        if tower_bits and self.llama_type not in _BARE:
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

        fitted = fit_lora_to(self.decoder, lora_tree)
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
                decoder = self.decoder
                self._set_decoder(merge_lora(decoder,
                                             fit_lora_to(decoder, lora_tree)))
            else:
                self.load_lora(lora_tree)
        self._generator = None

    # -- API ----------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return decoder_device(self.decoder)

    def _decoder_params(self) -> dict:
        """The decoder with every loaded adapter attached (meta.py:454)."""
        from a3vlm_tpu_torch.train.lora import attach_lora

        p = self.decoder
        for lora in self._loras:
            p = attach_lora(p, lora)
        return p

    def _image_tokens(self, images, depth_images, impl: str
                      ) -> Optional[torch.Tensor]:
        """Image tokens of the family (meta.py:429-452), recording the
        gradient of the projectors and tags. A numpy batch goes to the
        model's device in the towers' dtype."""
        if images is None:
            return None
        if self.llama_type in _BARE:
            # the JAX method fails here too: its decoder module has no
            # build_image_tokens
            raise ValueError(f"llama_type {self.llama_type} takes no images")

        def to_device(x):
            if isinstance(x, torch.Tensor):
                return x
            return torch.as_tensor(np.asarray(x), device=self.device,
                                   dtype=self.params["start_img"].dtype)

        images = to_device(images)
        if self.llama_type == "llama_ens5_2images":
            if depth_images is None:
                raise ValueError("llama_ens5_2images requires depth images "
                                 "(llama_ens5_2images.py:518-547)")
            return e2_mod.build_image_tokens(self.params, self.cfg, images,
                                             to_device(depth_images), impl)
        return self._mod.build_image_tokens(self.params, self.cfg, images,
                                            impl)

    @on_mesh
    @torch.inference_mode()
    def encode_images(self, images, depth_images=None, impl: str = "auto"
                      ) -> Optional[torch.Tensor]:
        """NHWC CLIP-normalized images -> image tokens (meta.py:429):
        [B, image_words, D]. ``llama_ens5_2images`` needs ``depth_images``
        beside ``images``; ``llama`` takes none."""
        return self._image_tokens(images, depth_images, impl)

    def get_image_words(self) -> int:
        return self.image_words

    def get_quant_blocklist(self) -> list[str]:
        """Subtrees left dense by ``quantize`` (meta.py:715): the ens5
        families' towers and projectors, none for the others."""
        if self.llama_type.startswith("llama_ens5"):
            return list(ens5_mod.quant_blocklist())
        return []

    def get_trainable_params(self) -> dict:
        """The trainable mask (meta.py:720): the ens5 families' towers
        frozen; every leaf of the others trainable, as in the JAX method
        (which does not freeze ``internlm_ems5_light``'s towers)."""
        if self.llama_type.startswith("llama_ens5"):
            return ens5_mod.trainable_mask(self.params)
        return tree_map(lambda _: True, self.params)

    def forward(self, examples: torch.Tensor, labels: torch.Tensor,
                images: Optional[torch.Tensor] = None,
                depth_images: Optional[torch.Tensor] = None,
                impl: str = "auto") -> torch.Tensor:
        """Training loss (meta.py:464): next-token cross-entropy of the
        text positions, label 0 ignored, padded vocab masked. The towers
        run without gradient and take ``impl`` only as "plain" or
        "auto". A ``falcon`` model ignores images, as the JAX method
        does. On a mesh of several ranks (``self.mesh``) every rank passes
        the whole batch: the towers split its crops over every rank, each
        data rank runs the decoder on its rows, and every rank returns the
        mean over the whole batch's valid tokens. ``internlm_ems5_light``
        trains on one device only (its towers train: the JAX method
        freezes none of them)."""
        mesh = self.mesh if is_parallel(self.mesh) else None
        if mesh is not None and self.llama_type == "internlm_ems5_light":
            raise NotImplementedError(
                "internlm_ems5_light trains on one device: on a mesh its "
                "trainable towers would need their own split")
        with use_mesh(mesh):
            if self.llama_type == "falcon":
                examples, labels, data_mesh = _data_rows(examples, labels)
                logits = falcon_mod.forward_train(self._decoder_params(),
                                                  self.args, examples,
                                                  impl=impl)
                return next_token_loss(logits, labels,
                                       vocab_size=self.true_vocab,
                                       data_mesh=data_mesh)
            image_tokens = self._image_tokens(
                images, depth_images, "plain" if impl == "plain" else "auto")
            B = examples.shape[0]
            examples, labels, data_mesh = _data_rows(examples, labels)
            image_tokens = tp.data_rows(image_tokens, B)
            logits = llama_mod.forward_train(self._decoder_params(),
                                             self.args, examples,
                                             image_tokens=image_tokens,
                                             impl=impl)
            return next_token_loss(logits, labels,
                                   vocab_size=self.true_vocab,
                                   data_mesh=data_mesh)

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
                prefill_chunk=self._prefill_chunk, ops=self._gen_ops,
                mesh=self.mesh,
            )
        return self._generator

    @property
    def _gen_ops(self):
        return FALCON_GEN_OPS if self.llama_type == "falcon" else \
            LLAMA_GEN_OPS

    def generate_tokens(
        self,
        prompt_tokens: Sequence[Sequence[int]],
        images: Optional[torch.Tensor] = None,
        depth_images: Optional[torch.Tensor] = None,
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
        (``Generator.generate_tokens``). ``depth_images``: the depth
        stream of ``llama_ens5_2images``."""
        return self._timed(images, depth_images, impl, lambda gen, tokens: (
            gen.generate_tokens(
                prompt_tokens, image_tokens=tokens, max_gen_len=max_gen_len,
                temperature=temperature, top_p=top_p, stop_tokens=stop_tokens,
                seed=seed, impl=impl, fsm=fsm, draft_k=draft_k,
                lookup_max_n=lookup_max_n)))

    @on_mesh
    def _timed(self, images, depth_images, impl: str, run):
        """The path both entries share, one call of the span recorder
        (``utils/trace.py``): the ``towers`` span, synchronised, then
        ``run(generator, image_tokens)``; sets ``last_stats`` (the
        record's numbers), ``last_trace`` (the record) and
        ``last_spec_stats`` of this call."""
        gen = self._get_generator()
        with trace.call("generate") as rec:
            with trace.span("towers"):
                image_tokens = self.encode_images(images, depth_images, impl)
                synchronize(self.device)
            out = run(gen, image_tokens)
        self.last_stats = rec.stats()
        self.last_trace = rec
        self.last_spec_stats = gen.last_spec_stats
        return out

    def generate(
        self,
        prompts: list[str],
        images: Optional[torch.Tensor] = None,
        depth_images: Optional[torch.Tensor] = None,
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
        return self._timed(images, depth_images, impl,
                           lambda gen, tokens: gen.generate(
            prompts, image_tokens=tokens, max_gen_len=max_gen_len,
            temperature=temperature, top_p=top_p,
            additional_stop_symbols=additional_stop_symbols, seed=seed,
            impl=impl, fsm=fsm, draft_k=draft_k, lookup_max_n=lookup_max_n))

    @torch.inference_mode()
    def stream_generate(
        self,
        prompt: str,
        image=None,
        depth_image=None,
        max_gen_len: int = 512,
        temperature: float = 0.0,
        top_p: float = 0.95,
        additional_stop_symbols: Iterable[str] = (),
        seed: int = 0,
        impl: str = "auto",
    ):
        """Single-prompt streaming generation (meta.py:568): yields
        {"text", "end_of_content"} dicts, one a token, over the family's
        prefill of the whole prompt and one decode step a token. Sampling
        draws from a ``torch.Generator`` seeded with
        ``seed`` (the JAX method's key chain differs: sampled text agrees by
        distribution only). ``depth_image``: the depth stream of
        ``llama_ens5_2images``, which the JAX method cannot take."""
        from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype
        from a3vlm_tpu_torch.ops.sampling import sample_token

        if image is not None and np.ndim(image) == 3:
            image = image[None]
        if depth_image is not None and np.ndim(depth_image) == 3:
            depth_image = depth_image[None]
        image_tokens = self.encode_images(image, depth_image, impl)
        tok, args, device = self.tokenizer, self.args, self.device
        max_seq_len = args.max_seq_len - (
            self.image_words if image_tokens is not None else 0)
        prompt_tokens = tok.encode(prompt, bos=True, eos=False)
        prompt_tokens = prompt_tokens[-(max_seq_len - max_gen_len):]
        total_len = min(max_seq_len, max_gen_len + len(prompt_tokens))

        params = self._decoder_params()
        W = 0 if image_tokens is None else image_tokens.shape[1]
        ops = self._gen_ops
        # the mesh around each device call only: the caller runs between
        # the yields
        with use_mesh(self.mesh):
            cache = ops.create_cache(
                args, 1, total_len + W,
                kv_cache_dtype(self.kv_cache_bits, device), device)
            logits, cache, _ = ops.prefill(
                params, args, cache,
                torch.tensor([prompt_tokens], device=device), image_tokens,
                impl)
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
            with use_mesh(self.mesh):
                logits, cache = ops.decode_step(
                    params, args, cache,
                    torch.tensor([[next_token]], device=device),
                    cur_pos + W, impl)
        yield {"text": tok.decode(generated), "end_of_content": True}

    @on_mesh
    @torch.inference_mode()
    def compute_logits(self, examples: List, images=None, bos: bool = True,
                       eos: bool = False, impl: str = "auto",
                       depth_images=None) -> List[np.ndarray]:
        """(meta.py:635): right-padded batch forward; per-item float32
        logits over the true vocab, trimmed to each item's length.
        ``depth_images``: the depth stream of ``llama_ens5_2images``, which
        the JAX method cannot take. A ``falcon`` model ignores images, as
        the JAX method does."""
        if isinstance(examples, str):
            raise ValueError("compute_logits expects a batched LIST")
        if isinstance(examples[0], str):
            examples = [self.tokenizer.encode(e, bos, eos) for e in examples]
        lens = [len(e) for e in examples]
        toks = torch.zeros((len(examples), max(lens)), dtype=torch.int64)
        for i, e in enumerate(examples):
            toks[i, : len(e)] = torch.tensor(e)
        if self.llama_type == "falcon":
            logits = falcon_mod.forward_train(
                self._decoder_params(), self.args, toks.to(self.device),
                impl=impl)
        else:
            image_tokens = self.encode_images(images, depth_images, impl)
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


def _data_rows(examples: torch.Tensor, labels: torch.Tensor):
    """This data rank's rows of a batch's ids and labels and the mesh the
    loss sums over (None where the batch is not split over "data")."""
    B = examples.shape[0]
    if not tp.data_split(B):
        return examples, labels, None
    return (tp.data_rows(examples, B), tp.data_rows(labels, B),
            current_mesh())


def data_local_batch(llama_type: str, params: dict, cfg, batch: dict,
                     tower_impl: str = "auto") -> Optional[dict]:
    """This rank's rows of a whole training batch (the training CLI's
    loss; inside ``use_mesh``), or None where the batch does not split
    over "data": ``examples`` and ``labels`` by rows; each image stream
    through the frozen towers on the whole batch (its crops split over
    every rank, the features the same bytes on every rank) or its cached
    features, cut to the rows (``image_feat_q`` / ``image_feat_ens``,
    ``depth_feat_q`` / ``depth_feat_ens``)."""
    B = batch["examples"].shape[0]
    if not tp.data_split(B):
        return None
    out = {k: tp.data_rows(batch[k], B) for k in ("examples", "labels")}
    if not llama_type.startswith("llama_ens5"):
        return out
    for img, q, ens in (("image", "image_feat_q", "image_feat_ens"),
                        ("depth_image", "depth_feat_q", "depth_feat_ens")):
        if batch.get(img) is not None:
            feats = ens5_mod.encode_image_features(params, cfg, batch[img],
                                                   tower_impl)
        elif q in batch:
            feats = {"q": batch[q], "ens": batch[ens]}
        else:
            continue
        out[q] = tp.data_crop_rows(feats["q"], B)
        out[ens] = tp.data_crop_rows(feats["ens"], B)
    return out


def _default_config(llama_type: str, llama_config, max_seq_len: int):
    """The family's config when the caller gives none (meta.py:67-160):
    ``ModelArgs()`` (LLaMA-2-13B) with ``max_seq_len`` under
    ``llama_config``'s fields, bare for ``llama`` and in an ``Ens5Config``
    for the ens5 families; ``InternlmEns5Config()`` with
    ``llama_config``'s fields over InternLM2-7B's; ``FalconArgs()`` with
    ``llama_config``'s fields (meta.py:88-101)."""
    if llama_type == "falcon":
        fields = {f.name for f in dataclasses.fields(falcon_mod.FalconArgs)}
        return falcon_mod.FalconArgs(**{
            k: v for k, v in load_config_union(llama_config or []).items()
            if k in fields})
    if llama_type == "internlm_ems5_light":
        cfg = il_mod.InternlmEns5Config()
        if not llama_config:
            return cfg
        fields = {f.name for f in dataclasses.fields(ModelArgs)}
        return dataclasses.replace(cfg, llama=cfg.llama.replace(**{
            k: v for k, v in load_config_union(llama_config).items()
            if k in fields}))
    args = (model_args_from_json(llama_config, max_seq_len=max_seq_len)
            if llama_config else ModelArgs(max_seq_len=max_seq_len))
    return args if llama_type == "llama" else Ens5Config(llama=args)


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
