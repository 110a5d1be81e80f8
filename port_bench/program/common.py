"""What the program adapters share: the port's int8-activation switches
(the control), the decoder's int4 layers made one at a time by the port's
quantizer, and one static batch through ``MetaModel.generate_tokens``."""

from __future__ import annotations

import time

import torch


def mismatch(key, stated, port) -> None:
    raise ValueError(f"the configuration states {key} = {stated!r}; the "
                     f"program runs {port!r}")


def set_a8(on: bool) -> None:
    """The port's lower-precision paths, all on (the control) or all off:
    int8 activations in the int4 GEMV (W4A8) and in the prefill (W8A8)."""
    from a3vlm_tpu_torch.ops import quant_matmul

    quant_matmul.W4A8_DECODE = on
    quant_matmul.W8A8_PREFILL = on


def int4_layers(arch, cfg: dict, seed: int, device) -> list:
    """The decoder's layers, each drawn dense and at once made int4 by the
    port's quantizer, so the dense model never sits on the card whole."""
    from a3vlm_tpu_torch.quant import GROUP_SIZE, quantize_params

    q = cfg["quant"]
    if q["group_size"] != GROUP_SIZE:
        mismatch("quant.group_size", q["group_size"], GROUP_SIZE)
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        layers.append(quantize_params(
            {"layers": [arch.draw_layer(cfg, seed, i, device)]},
            bits=q["bits"])["layers"][0])
    return layers


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_batch(model, prompts, images, new_ids: int) -> tuple:
    """One static batch, greedy, no stop ids: (each row's generated ids,
    the batch's host seconds, the model's ``last_stats``)."""
    t0 = time.perf_counter()
    out = model.generate_tokens(prompts, images=images, max_gen_len=new_ids,
                                temperature=0.0, stop_tokens=())
    return out, time.perf_counter() - t0, dict(model.last_stats)
