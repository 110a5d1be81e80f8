"""Falcon (the new decoder architecture): its sizes as the benchmark
reads them from a configuration file (Falcon's ``config.json`` keys), its
dense weights drawn from a seed in the program's parameter layout, layer
by layer, and the model FLOPs that a batch's inputs need. Plain torch;
imports nothing of the program.

The draw: linears N(0, 1/fan_in), the two output projections of each
layer (attention ``wo`` and ``dense_4h_to_h``) shrunk by 1/sqrt(2 L),
LayerNorm weights of 1 with the outlier channels of
``seeding.norm_gains`` (the same channels in every LayerNorm), zero
biases, unit-variance embeddings."""

from __future__ import annotations

import torch

from port_bench.seeding import fill, generator, norm_gains


def dims(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return {"D": D, "L": cfg["num_hidden_layers"], "H": H,
            "Hkv": cfg["num_kv_heads"], "hd": D // H, "F": 4 * D,
            "V": cfg["vocab_size"]}


def int4_linears(cfg: dict) -> list:
    """(K, N, launches a token step) of every int4 product: the six
    linears of each layer and the head."""
    d = dims(cfg)
    D, L, qd, kd = d["D"], d["L"], d["H"] * d["hd"], d["Hkv"] * d["hd"]
    per_layer = [(D, qd), (D, kd), (D, kd), (qd, D), (D, d["F"]),
                 (d["F"], D)]
    return [(K, N, L) for K, N in per_layer] + [(D, d["V"], 1)]


def _dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg.get("dtype", "bfloat16"))


def _ln(n, dtype, device, seed):
    return {"weight": norm_gains(n, seed, "decoder", device, dtype),
            "bias": torch.zeros(n, dtype=dtype, device=device)}


def draw_layer(cfg: dict, seed: int, i: int, device) -> dict:
    """Layer ``i``, dense, in the program's layout (linear weights [in,
    out]; query head h reads kv head h // (H / Hkv)); one ``randn`` call
    from the layer's own stream."""
    d = dims(cfg)
    D, F, qd, kd = d["D"], d["F"], d["H"] * d["hd"], d["Hkv"] * d["hd"]
    out_scale = (2 * d["L"]) ** -0.5
    dt = _dtype(cfg)
    wq, wk, wv, wo, up, down = fill(
        [((D, qd), D ** -0.5), ((D, kd), D ** -0.5), ((D, kd), D ** -0.5),
         ((qd, D), qd ** -0.5 * out_scale), ((D, F), D ** -0.5),
         ((F, D), F ** -0.5 * out_scale)],
        generator(device, seed, "layer", i), device, dt)
    return {
        "attention": {"wq": {"weight": wq}, "wk": {"weight": wk},
                      "wv": {"weight": wv}, "wo": {"weight": wo}},
        "mlp": {"dense_h_to_4h": {"weight": up},
                "dense_4h_to_h": {"weight": down}},
        "ln_attn": _ln(D, dt, device, seed),
        "ln_mlp": _ln(D, dt, device, seed),
    }


def draw_decoder_rest(cfg: dict, seed: int, device) -> dict:
    """The embedding, the final LayerNorm and the head (dense)."""
    d = dims(cfg)
    emb, head = fill([((d["V"], d["D"]), 1.0),
                      ((d["D"], d["V"]), d["D"] ** -0.5)],
                     generator(device, seed, "decoder"), device, _dtype(cfg))
    return {"word_embeddings": {"weight": emb},
            "ln_f": _ln(d["D"], _dtype(cfg), device, seed),
            "output": {"weight": head}}


def batch_flops(cfg: dict, prompt_lens, gen_lens, distinct_images: int = 0
                ) -> float:
    """The model FLOPs a batch's inputs need: each row's prompt ids and
    every generated id but the last through the decoder once, attending
    its whole prefix; the head once for each generated id."""
    d = dims(cfg)
    lin2 = 2 * sum(K * N * n for K, N, n in int4_linears(cfg)[:-1])
    att = 4 * d["L"] * d["H"] * d["hd"]
    head = 2 * d["D"] * d["V"]
    total = 0
    for P, G in zip(prompt_lens, gen_lens):
        n = P + G - 1
        total += n * lin2 + att * (n * (n + 1) // 2) + G * head
    return float(total)


def image_words(cfg: dict) -> int:
    return 0
