"""Single-process serving facade (counterpart of a3vlm_tpu/serving.py; the
reference's model/accessory/model/multi_gpu_wrapper.py). The reference
spawns one process per GPU behind an RPC control plane so that one
application can drive a model sharded over several devices. On one device
the wrapper reduces to a convenience class that:

- builds or loads a ``MetaModel``,
- places its weights on the device (nothing to shard),
- exposes the same generate / stream_generate / compute_logits /
  evaluate_examples surface with host-side image arrays.

Several devices (``model_parallel_size > 1``, the JAX class's mesh) are not
ported: ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch


class ModelServer:
    def __init__(
        self,
        pretrained_path: Optional[str | list] = None,
        llama_type: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        model_parallel_size: int = 1,
        max_seq_len: int = 4096,
        quant: bool = False,
        meta_model=None,
        kv_cache_bits: Optional[int] = None,
        device: torch.device | str = "cuda",
        tokenizer=None,
    ):
        """As the JAX constructor (serving.py:21-66) on one device:
        ``meta_model`` is served as given, else ``MetaModel.from_pretrained``
        loads ``pretrained_path`` onto ``device`` (the card, unless the
        caller names another), int4 with ``quant``. ``tokenizer``, an
        object, stands in for ``tokenizer_path``, as ``from_pretrained``
        takes it."""
        from a3vlm_tpu_torch.meta import MetaModel

        if model_parallel_size != 1:
            raise ValueError(
                f"model_parallel_size {model_parallel_size}: several "
                "devices are not ported yet (ROADMAP Queue 1 item 17)")
        if meta_model is not None:
            self.model = meta_model
        else:
            self.model = MetaModel.from_pretrained(
                pretrained_path,
                llama_type=llama_type,
                tokenizer_path=tokenizer_path,
                with_visual=True,
                max_seq_len=max_seq_len,
                vocab_align=model_parallel_size * 128,
                device=device,
                tokenizer=tokenizer,
            )
            if quant:
                # the JAX call's tp_align and row_parallel are 0 at one
                # device; the port's quantize has neither
                self.model.quantize()
        if kv_cache_bits is not None:
            # int8 KV cache (serving extension; ops/decode_attention.py)
            self.model.kv_cache_bits = kv_cache_bits
        self._place_params()

    def _place_params(self):
        """One device: the weights already lie where ``from_pretrained`` or
        the caller put them. The cached generator is dropped, as the JAX
        method drops it after placing (serving.py:94-95)."""
        self.model._generator = None

    # -- API (multi_gpu_wrapper.py:260-320 surface) --------------------------

    def generate(
        self,
        prompts: List[str],
        images=None,
        max_gen_len: int = 512,
        temperature: float = 0.0,
        top_p: float = 0.95,
        additional_stop_symbols: Iterable[str] = (),
        **kw,
    ) -> List[str]:
        # **kw delegation (like stream_generate below): every MetaModel
        # generate kwarg (fsm, draft_k, seed, ...) flows through without
        # this facade having to chase the signature
        if images is not None and not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        return self.model.generate(
            prompts,
            images=images,
            max_gen_len=max_gen_len,
            temperature=temperature,
            top_p=top_p,
            additional_stop_symbols=additional_stop_symbols,
            **kw,
        )

    def stream_generate(self, prompt: str, image=None, **kw):
        yield from self.model.stream_generate(prompt, image=image, **kw)

    def compute_logits(self, examples, images=None, **kw):
        return self.model.compute_logits(examples, images=images, **kw)

    def evaluate_examples(self, examples, contexts=None, images=None, **kw):
        return self.model.evaluate_examples(
            examples, contexts=contexts, images=images, **kw
        )
