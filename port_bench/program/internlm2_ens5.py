"""The program under test for the released A3VLM 7B: the port's
``MetaModel("internlm_ems5_light")`` built from the configuration file and
the benchmark's dense weights, the decoder's int4 weights made by the
port's own quantizer one layer at a time, driven through
``MetaModel.generate_tokens`` as ``eval_affordance.run_eval`` drives it."""

from __future__ import annotations

import torch

from port_bench.arch import internlm2_ens5 as arch
from port_bench.program import common


def port_config(cfg: dict):
    from a3vlm_tpu_torch.config import ConvNeXtConfig, ModelArgs, ViTConfig
    from a3vlm_tpu_torch.models import ens5
    from a3vlm_tpu_torch.models.internlm_ems5_light import (
        InternlmEns5Config,
    )

    t = cfg["towers"]
    consts = {"input_mean": ens5.CLIP_MEAN, "input_std": ens5.CLIP_STD,
              "dinov2_mean": ens5.DINOV2_MEAN, "dinov2_std": ens5.DINOV2_STD,
              "proj_norm_eps": 1e-5}
    for k, v in consts.items():
        got = tuple(t[k]) if isinstance(v, tuple) else t[k]
        if got != v:
            common.mismatch(k, got, v)
    F = cfg["intermediate_size"]
    llama = ModelArgs(
        dim=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], vocab_size=cfg["vocab_size"],
        multiple_of=F, ffn_dim_multiplier=None, norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), max_seq_len=cfg["max_seq_len"])
    if llama.ffn_hidden_dim != F:
        common.mismatch("intermediate_size", F, llama.ffn_hidden_dim)
    v, c = t["dinov2"], t["convnext"]
    return InternlmEns5Config(
        llama=llama,
        convnext=ConvNeXtConfig(depths=tuple(c["depths"]),
                                dims=tuple(c["dims"]),
                                norm_eps=c["norm_eps"]),
        dinov2=ViTConfig(
            image_size=t["dino_crop"], patch_size=v["patch_size"],
            width=v["width"], layers=v["layers"], heads=v["heads"],
            mlp_dim=v["mlp_dim"], act="gelu", ln_pre=False, ln_post=True,
            use_swiglu=True, layer_scale=True,
            pos_grid_size=v["pos_grid_size"], norm_eps=v["norm_eps"]),
        image_size=t["image_size"], dino_crop=t["dino_crop"],
        convnext_crop=t["convnext_crop"])


def build(cfg: dict, seed: int, device, control: bool = False):
    """The model on ``device`` from ``seed``; ``control``: with the port's
    int8-activation paths on (W4A8 decode, W8A8 prefill, int8 towers)."""
    from a3vlm_tpu_torch.meta import MetaModel

    common.set_a8(control)
    layers = common.int4_layers(arch, cfg, seed, device)
    params = arch.draw_towers(cfg, seed, device)
    params["llama"] = {**arch.draw_decoder_rest(cfg, seed, device),
                       "layers": layers}
    model = MetaModel("internlm_ems5_light", with_visual=True,
                      dtype=torch.bfloat16, params=params,
                      vocab_size=cfg["vocab_size"], model_cfg=port_config(cfg),
                      device=device)
    model.quantize(bits=cfg["quant"]["bits"],
                   tower_bits=8 if control else None)
    common.sync(device)
    return model

