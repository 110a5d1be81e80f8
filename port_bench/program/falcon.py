"""The program under test for a Falcon stage: the port's
``MetaModel("falcon")`` built from the configuration file and the
benchmark's dense weights, every layer made int4 by the port's quantizer
as it is drawn, the head after; driven through
``MetaModel.generate_tokens``."""

from __future__ import annotations

import torch

from port_bench.arch import falcon as arch
from port_bench.program import common


def port_config(cfg: dict):
    from a3vlm_tpu_torch.models.falcon import FalconArgs

    if not (cfg["new_decoder_architecture"] and cfg["parallel_attn"]
            and not cfg["bias"] and not cfg.get("alibi", False)):
        common.mismatch("architecture", "another Falcon layout",
                        "the new decoder architecture, parallel, no bias")
    return FalconArgs(
        num_layers=cfg["num_hidden_layers"], hidden_size=cfg["hidden_size"],
        num_attention_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_kv_heads"], bias=False, multi_query=False,
        new_decoder_architecture=True, parallel_attn=True,
        layer_norm_epsilon=cfg["layer_norm_epsilon"],
        vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        max_seq_len=cfg["max_position_embeddings"])


def build(cfg: dict, seed: int, device, control: bool = False):
    """The model on ``device`` from ``seed``; ``control``: with the port's
    int8-activation paths on (W4A8 decode, W8A8 prefill)."""
    from a3vlm_tpu_torch.meta import MetaModel

    common.set_a8(control)
    params = {**arch.draw_decoder_rest(cfg, seed, device),
              "layers": common.int4_layers(arch, cfg, seed, device)}
    model = MetaModel("falcon", dtype=torch.bfloat16, params=params,
                      vocab_size=cfg["vocab_size"], model_cfg=port_config(cfg),
                      max_seq_len=cfg["max_position_embeddings"],
                      device=device)
    model.quantize(bits=cfg["quant"]["bits"])
    common.sync(device)
    return model

