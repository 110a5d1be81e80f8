"""Plain float32 reference of the released A3VLM 7B: the DINOv2 and
ConvNeXt towers over the two-scale crops of a 1024 px image, the
projector, the image tags, and the InternLM2 decoder (RMSNorm, grouped
query attention, LLaMA's rotary pairs, SwiGLU) with its int4 weights
worked out here from the dense weights (``int4.dequantized``). It takes
the seed, the configuration and the inputs, draws the dense weights again
(``arch.internlm2_ens5``), and runs each request's whole sequence at once,
layer by layer, with no cache. Imports nothing of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.arch import internlm2_ens5 as arch
from port_bench.reference.common import (
    causal_attention,
    float32_exact,
    full_attention,
    layer_norm,
    resize,
    rms_norm,
    rope_angles,
    rope_pairs,
)
from port_bench.reference.int4 import dequantized


def _vit(p, t, pixels):
    """pixels [B, S, S, 3] -> [B, 1 + g * g, width] after ln_post."""
    W, ps, eps = t["width"], t["patch_size"], t["norm_eps"]
    x = F.conv2d(pixels.permute(0, 3, 1, 2), p["patch_embed"]["kernel"]
                 .float(), p["patch_embed"]["bias"].float(), stride=ps)
    B, _, g, _ = x.shape
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([p["class_embedding"].float().expand(B, 1, W), x], 1)
    pos = p["positional_embedding"].float()
    G = t["pos_grid_size"]
    if G != g:
        patch = resize(pos[1:].view(G, G, W), g, g).reshape(g * g, W)
        pos = torch.cat([pos[:1], patch])
    x = x + pos
    b = p["blocks"]
    heads = t["heads"]

    def lin(y, leaf, i):
        return y @ leaf["weight"][i].float() + leaf["bias"][i].float()

    def ln(y, leaf, i):
        return layer_norm(y, {"weight": leaf["weight"][i],
                              "bias": leaf["bias"][i]}, eps)

    for i in range(t["layers"]):
        q, k, v = lin(ln(x, b["ln1"], i), b["attn"]["wqkv"], i).split(W, -1)
        shape = (B, -1, heads, W // heads)
        a = full_attention(q.reshape(shape), k.reshape(shape),
                           v.reshape(shape))
        x = x + lin(a, b["attn"]["wo"], i) * b["ls1"][i].float()
        gate, up = lin(ln(x, b["ln2"], i), b["mlp"]["fc1"], i).chunk(2, -1)
        x = x + lin(F.silu(gate) * up, b["mlp"]["fc2"], i) * \
            b["ls2"][i].float()
    return layer_norm(x, p["ln_post"], eps)


def _conv(x, p, stride, groups=1, pad=0):
    return F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].float(),
                    p["bias"].float(), stride=stride, padding=pad,
                    groups=groups).permute(0, 2, 3, 1)


def _convnext(p, t, pixels):
    """pixels [B, S, S, 3] -> [B, S / 32, S / 32, dims[-1]]."""
    eps = t["norm_eps"]
    x = layer_norm(_conv(pixels, p["stem"]["conv"], 4), p["stem"]["norm"],
                   eps)
    for stage in p["stages"]:
        if "downsample" in stage:
            ds = stage["downsample"]
            x = _conv(layer_norm(x, ds["norm"], eps), ds["conv"], 2)
        for bp in stage["blocks"]:
            h = _conv(x, bp["dwconv"], 1, groups=x.shape[-1], pad=3)
            h = layer_norm(h, bp["norm"], eps)
            h = F.gelu(h @ bp["pw1"]["weight"].float()
                       + bp["pw1"]["bias"].float())
            h = h @ bp["pw2"]["weight"].float() + bp["pw2"]["bias"].float()
            x = x + h * bp["gamma"].float()
    return layer_norm(x, p["head_norm"], eps)


def image_tokens(cfg: dict, towers: dict, image: torch.Tensor):
    """One normalised image [S, S, 3] -> its image words [1295, D]: five
    crops a tower (the image shrunk to the crop, then the four quadrants,
    of the image shrunk to twice the crop for DINOv2 and of the image
    itself for ConvNeXt), ConvNeXt's map with its mean in front beside
    DINOv2's tokens, the projector, each crop between the two tags."""
    t = cfg["towers"]
    img = image[None].float()
    c, C, half = t["dino_crop"], t["convnext_crop"], t["image_size"] // 2
    two = resize(img, 2 * c, 2 * c)
    dino = torch.cat([resize(img, c, c), two[:, :c, :c], two[:, :c, c:],
                      two[:, c:, :c], two[:, c:, c:]])
    quads = [img[:, :half, :half], img[:, :half, half:],
             img[:, half:, :half], img[:, half:, half:]]
    if half != C:
        quads = [resize(q, C, C) for q in quads]
    cn_in = torch.cat([resize(img, C, C)] + quads)

    cn = _convnext(towers["convnext"], t["convnext"], cn_in)
    cn = cn.reshape(5, -1, cn.shape[-1])
    cn = torch.cat([cn.mean(1, keepdim=True), cn], 1)
    dev = image.device
    cm, cs = (torch.tensor(t[k], device=dev) for k in ("input_mean",
                                                        "input_std"))
    dm, ds = (torch.tensor(t[k], device=dev) for k in ("dinov2_mean",
                                                        "dinov2_std"))
    dino = _vit(towers["dinov2"], t["dinov2"],
                dino * (cs / ds) + (cm - dm) / ds)
    proj = towers["visual_proj"]
    ens = (torch.cat([cn, dino], -1) @ proj["linear"]["weight"].float()
           + proj["linear"]["bias"].float())
    ens = layer_norm(ens, proj["ln"], t["proj_norm_eps"])
    start = towers["start_img"].float().reshape(1, -1)
    end = towers["end_img"].float().reshape(1, -1)
    return torch.cat([x for k in range(5) for x in (start, ens[k], end)])


_LINEARS = (("attention", "wq"), ("attention", "wk"), ("attention", "wv"),
            ("attention", "wo"), ("feed_forward", "w1"),
            ("feed_forward", "w2"), ("feed_forward", "w3"))


def served_logits(cfg: dict, seed: int, requests: list, images: dict,
                  device) -> list:
    """For each request (``prompt`` ids with BOS, the ``served`` ids, the
    key of its ``image`` in ``images`` or None): float32 logits [len(served),
    V], row j the distribution the reference gives for served id j."""
    d = arch.dims(cfg)
    H, Hkv, hd, eps = d["H"], d["Hkv"], d["hd"], cfg["rms_norm_eps"]
    with float32_exact():
        words = {}
        keys = {r["image"] for r in requests if r["image"] is not None}
        if keys:
            towers = arch.draw_towers(cfg, seed, device)
            words = {k: image_tokens(cfg, towers, images[k]) for k in keys}
            del towers
        rest = arch.draw_decoder_rest(cfg, seed, device)
        emb = rest["tok_embeddings"]["weight"]
        rows, spans = [], []
        for r in requests:
            ids = torch.tensor(r["prompt"] + r["served"][:-1], device=device)
            e = emb[ids].float()
            if r["image"] is not None:
                e = torch.cat([e[:1], words[r["image"]], e[1:]])
            spans.append((sum(len(x) for x in rows), len(e)))
            rows.append(e)
        h = torch.cat(rows)
        del rows, words
        cos, sin = rope_angles(max(n for _, n in spans), hd,
                               cfg["rope_theta"], device)
        for i in range(d["L"]):
            lw = arch.draw_layer(cfg, seed, i, device)
            wq, wk, wv, wo, w1, w2, w3 = (dequantized(lw[a][b]["weight"])
                                          for a, b in _LINEARS)
            x = rms_norm(h, lw["attention_norm"]["weight"], eps)
            q, k, v = x @ wq, x @ wk, x @ wv
            att = torch.empty_like(q)
            for s, n in spans:
                att[s:s + n] = causal_attention(
                    rope_pairs(q[s:s + n].view(n, H, hd), cos[:n], sin[:n]),
                    rope_pairs(k[s:s + n].view(n, Hkv, hd), cos[:n],
                               sin[:n]),
                    v[s:s + n].view(n, Hkv, hd))
            h = h + att @ wo
            del q, k, v, att, x
            x = rms_norm(h, lw["ffn_norm"]["weight"], eps)
            h = h + (F.silu(x @ w1) * (x @ w3)) @ w2
            del lw, wq, wk, wv, wo, w1, w2, w3, x
        head = dequantized(rest["output"]["weight"])
        out = []
        for r, (s, n) in zip(requests, spans):
            G = len(r["served"])
            x = rms_norm(h[s + n - G: s + n], rest["norm"]["weight"], eps)
            out.append(x @ head)
        return out
