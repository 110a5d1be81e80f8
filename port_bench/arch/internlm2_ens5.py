"""The released A3VLM 7B (``internlm_ems5_light``): its sizes as the
benchmark reads them from a configuration file, its dense weights drawn
from a seed in the program's parameter layout, and the model FLOPs that
a batch's inputs need. Plain torch; imports nothing of the program.

Sizes come from the configuration file (``configs/<name>.json``): the
decoder under InternLM2's ``config.json`` keys, the towers under
``towers``. The draw keeps every activation near unit scale at any depth:
linears N(0, 1/fan_in), the residual branches' output projections (and
the towers' layer scales) shrunk by 1/sqrt(2 L), zero biases,
unit-variance embeddings and image tags, and norm weights of 1 with the
outlier channels of ``seeding.norm_gains`` (the same channels in every
norm of a module)."""

from __future__ import annotations

import torch

from port_bench.seeding import fill, generator, norm_gains


def dims(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    t = cfg["towers"]
    grid = t["dino_crop"] // t["dinov2"]["patch_size"]
    return {
        "D": D, "L": cfg["num_hidden_layers"], "H": H,
        "Hkv": cfg["num_key_value_heads"], "hd": D // H,
        "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
        "grid": grid, "tokens_per_crop": grid * grid + 1,
        "image_words": 5 * (grid * grid + 1 + 2),
        "ens_dim": t["convnext"]["dims"][-1] + t["dinov2"]["width"],
    }


def int4_linears(cfg: dict) -> list:
    """(K, N, launches a token step) of every int4 product of the decoder:
    the seven linears of each layer and the head."""
    d = dims(cfg)
    D, L, hd = d["D"], d["L"], d["hd"]
    per_layer = [(D, d["H"] * hd), (D, d["Hkv"] * hd), (D, d["Hkv"] * hd),
                 (d["H"] * hd, D), (D, d["F"]), (D, d["F"]), (d["F"], D)]
    return [(K, N, L) for K, N in per_layer] + [(D, d["V"], 1)]


def _dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg.get("dtype", "bfloat16"))


def draw_layer(cfg: dict, seed: int, i: int, device) -> dict:
    """Decoder layer ``i``, dense, in the program's layout (linear weights
    [in, out]); one ``randn`` call from the layer's own stream."""
    d = dims(cfg)
    D, F, qd, kd = d["D"], d["F"], d["H"] * d["hd"], d["Hkv"] * d["hd"]
    out_scale = (2 * d["L"]) ** -0.5
    wq, wk, wv, wo, w1, w2, w3 = fill(
        [((D, qd), D ** -0.5), ((D, kd), D ** -0.5), ((D, kd), D ** -0.5),
         ((qd, D), qd ** -0.5 * out_scale), ((D, F), D ** -0.5),
         ((F, D), F ** -0.5 * out_scale), ((D, F), D ** -0.5)],
        generator(device, seed, "layer", i), device, _dtype(cfg))
    gains = norm_gains(D, seed, "decoder", device, _dtype(cfg))
    return {
        "attention": {"wq": {"weight": wq}, "wk": {"weight": wk},
                      "wv": {"weight": wv}, "wo": {"weight": wo}},
        "feed_forward": {"w1": {"weight": w1}, "w2": {"weight": w2},
                         "w3": {"weight": w3}},
        "attention_norm": {"weight": gains},
        "ffn_norm": {"weight": gains.clone()},
    }


def draw_decoder_rest(cfg: dict, seed: int, device) -> dict:
    """The embedding, the final norm and the head (dense)."""
    d = dims(cfg)
    emb, head = fill([((d["V"], d["D"]), 1.0), ((d["D"], d["V"]),
                                                  d["D"] ** -0.5)],
                     generator(device, seed, "decoder"), device, _dtype(cfg))
    return {"tok_embeddings": {"weight": emb},
            "norm": {"weight": norm_gains(d["D"], seed, "decoder", device,
                                          _dtype(cfg))},
            "output": {"weight": head}}


def _ln(n, dtype, device, seed, tag, lead=()):
    return {"weight": norm_gains(n, seed, tag, device, dtype, lead),
            "bias": torch.zeros(*lead, n, dtype=dtype, device=device)}


def draw_dinov2(cfg: dict, seed: int, device) -> dict:
    t = cfg["towers"]["dinov2"]
    W, L, M, p = t["width"], t["layers"], t["mlp_dim"], t["patch_size"]
    dt = _dtype(cfg)
    g = t["pos_grid_size"]
    patch, cls, pos, qkv, wo, fc1, fc2 = fill(
        [((W, 3, p, p), (3 * p * p) ** -0.5), ((W,), 0.02),
         ((g * g + 1, W), 0.02), ((L, W, 3 * W), W ** -0.5),
         ((L, W, W), W ** -0.5), ((L, W, 2 * M), W ** -0.5),
         ((L, M, W), M ** -0.5)],
        generator(device, seed, "dinov2"), device, dt)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dt, device=device)

    scale = (2 * L) ** -0.5
    return {
        "patch_embed": {"kernel": patch, "bias": zeros(W)},
        "class_embedding": cls,
        "positional_embedding": pos,
        "blocks": {
            "ln1": _ln(W, dt, device, seed, "dinov2", (L,)),
            "attn": {"wqkv": {"weight": qkv, "bias": zeros(L, 3 * W)},
                     "wo": {"weight": wo, "bias": zeros(L, W)}},
            "ln2": _ln(W, dt, device, seed, "dinov2", (L,)),
            "mlp": {"fc1": {"weight": fc1, "bias": zeros(L, 2 * M)},
                    "fc2": {"weight": fc2, "bias": zeros(L, W)}},
            "ls1": torch.full((L, W), scale, dtype=dt, device=device),
            "ls2": torch.full((L, W), scale, dtype=dt, device=device),
        },
        "ln_post": _ln(W, dt, device, seed, "dinov2"),
    }


def draw_convnext(cfg: dict, seed: int, device) -> dict:
    t = cfg["towers"]["convnext"]
    depths, cdims = t["depths"], t["dims"]
    dt = _dtype(cfg)
    specs = [((cdims[0], 3, 4, 4), 48 ** -0.5)]
    for si, (depth, dim) in enumerate(zip(depths, cdims)):
        if si > 0:
            specs.append(((dim, cdims[si - 1], 2, 2),
                          (4 * cdims[si - 1]) ** -0.5))
        for _ in range(depth):
            specs += [((dim, 1, 7, 7), 49 ** -0.5),
                      ((dim, 4 * dim), dim ** -0.5),
                      ((4 * dim, dim), (4 * dim) ** -0.5)]
    leaves = iter(fill(specs, generator(device, seed, "convnext"), device,
                       dt))
    stem = next(leaves)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    gamma = (2 * sum(depths)) ** -0.5
    stages = []
    for si, (depth, dim) in enumerate(zip(depths, cdims)):
        stage = {}
        if si > 0:
            stage["downsample"] = {"norm": _ln(cdims[si - 1], dt, device, seed,
                                               "convnext"),
                                   "conv": {"kernel": next(leaves),
                                            "bias": zeros(dim)}}
        blocks = []
        for _ in range(depth):
            dw, pw1, pw2 = next(leaves), next(leaves), next(leaves)
            blocks.append({
                "dwconv": {"kernel": dw, "bias": zeros(dim)},
                "norm": _ln(dim, dt, device, seed, "convnext"),
                "pw1": {"weight": pw1, "bias": zeros(4 * dim)},
                "pw2": {"weight": pw2, "bias": zeros(dim)},
                "gamma": torch.full((dim,), gamma, dtype=dt, device=device),
            })
        stage["blocks"] = blocks
        stages.append(stage)
    return {"stem": {"conv": {"kernel": stem, "bias": zeros(cdims[0])},
                     "norm": _ln(cdims[0], dt, device, seed, "convnext")},
            "stages": stages,
            "head_norm": _ln(cdims[-1], dt, device, seed, "convnext")}


def draw_towers(cfg: dict, seed: int, device) -> dict:
    """The towers, the projector and the image tags (dense), as the
    program's ``internlm_ems5_light`` tree holds them."""
    d = dims(cfg)
    dt = _dtype(cfg)
    proj, start, end = fill([((d["ens_dim"], d["D"]), d["ens_dim"] ** -0.5),
                             ((1, 1, d["D"]), 1.0), ((1, 1, d["D"]), 1.0)],
                            generator(device, seed, "proj"), device, dt)
    return {
        "convnext": draw_convnext(cfg, seed, device),
        "dinov2": draw_dinov2(cfg, seed, device),
        "visual_proj": {
            "linear": {"weight": proj,
                       "bias": torch.zeros(d["D"], dtype=dt, device=device)},
            "ln": _ln(d["D"], dt, device, seed, "proj")},
        "start_img": start,
        "end_img": end,
    }


# ------------------------------------------------------------------ FLOPs
def decoder_token_flops(cfg: dict, ctx: int) -> float:
    """FLOPs of one token through every decoder layer, attending ``ctx``
    positions (itself included); the head is counted apart."""
    d = dims(cfg)
    lin = sum(K * N * n for K, N, n in int4_linears(cfg)[:-1])
    return 2 * lin + 4 * d["L"] * d["H"] * d["hd"] * ctx


def _sum_ctx(first: int, count: int) -> int:
    """Sum of ctx over ``count`` tokens whose first attends ``first``."""
    return count * first + count * (count - 1) // 2


def towers_flops(cfg: dict) -> float:
    """FLOPs of one image through the towers and the projector: the five
    crops of each tower (convolutions and products; no resize, norm or
    activation)."""
    t = cfg["towers"]
    v = t["dinov2"]
    W, L, M, p = v["width"], v["layers"], v["mlp_dim"], v["patch_size"]
    grid = t["dino_crop"] // p
    T = grid * grid + 1
    vit = (2 * grid * grid * 3 * p * p * W
           + L * (2 * T * (3 * W * W + W * W + 2 * M * W + M * W)
                  + 4 * T * T * W))
    c = t["convnext"]
    r = t["convnext_crop"] // 4
    cnx = 2 * r * r * 48 * c["dims"][0]
    for si, (depth, dim) in enumerate(zip(c["depths"], c["dims"])):
        if si > 0:
            r //= 2
            cnx += 2 * r * r * 4 * c["dims"][si - 1] * dim
        cnx += depth * 2 * r * r * (49 * dim + 8 * dim * dim)
    d = dims(cfg)
    proj = 2 * T * d["ens_dim"] * d["D"]
    return 5 * (vit + cnx + proj)


def batch_flops(cfg: dict, prompt_lens, gen_lens, distinct_images: int
                ) -> float:
    """The model FLOPs a batch's inputs need: each distinct image once
    through the towers and, with BOS, once through the decoder as the
    prefix its questions share; each row's text after BOS and every
    generated id but the last through the decoder once, attending its
    whole prefix; the head once for each generated id."""
    d = dims(cfg)
    W = d["image_words"]
    lin2 = 2 * sum(K * N * n for K, N, n in int4_linears(cfg)[:-1])
    att = 4 * d["L"] * d["H"] * d["hd"]
    head = 2 * d["D"] * d["V"]
    total = distinct_images * (towers_flops(cfg) + (W + 1) * lin2
                               + att * _sum_ctx(1, W + 1))
    for P, G in zip(prompt_lens, gen_lens):
        n = P - 1 + G - 1
        total += n * lin2 + att * _sum_ctx(W + 2, n) + G * head
    return float(total)


def image_words(cfg: dict) -> int:
    return dims(cfg)["image_words"]
