"""Plain float32 reference of Falcon's new decoder architecture: attention
and an exact-GELU 4x MLP in parallel over one residual, each behind its
own LayerNorm, grouped-query attention, rotary over the two halves of a
head, a final LayerNorm and the head; the int4 weights worked out here
from the dense weights (``int4.dequantized``), drawn again layer by layer
(``arch.falcon``). No cache: each request's whole sequence at once.
Imports nothing of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.arch import falcon as arch
from port_bench.reference.common import (
    causal_attention,
    float32_exact,
    layer_norm,
    rope_angles,
    rope_halves,
)
from port_bench.reference.int4 import dequantized


def served_logits(cfg: dict, seed: int, requests: list, images: dict,
                  device) -> list:
    """For each request (``prompt`` ids, the ``served`` ids): float32
    logits [len(served), V], row j the distribution the reference gives
    for served id j."""
    d = arch.dims(cfg)
    H, Hkv, hd, eps = d["H"], d["Hkv"], d["hd"], cfg["layer_norm_epsilon"]
    with float32_exact():
        rest = arch.draw_decoder_rest(cfg, seed, device)
        emb = rest["word_embeddings"]["weight"]
        spans, rows = [], []
        for r in requests:
            ids = torch.tensor(r["prompt"] + r["served"][:-1], device=device)
            spans.append((sum(len(x) for x in rows), len(ids)))
            rows.append(emb[ids].float())
        h = torch.cat(rows)
        del rows
        cos, sin = rope_angles(max(n for _, n in spans), hd,
                               cfg.get("rope_theta", 10000.0), device)
        for i in range(d["L"]):
            lw = arch.draw_layer(cfg, seed, i, device)
            a = lw["attention"]
            x = layer_norm(h, lw["ln_attn"], eps)
            wq = dequantized(a["wq"]["weight"])
            q = x @ wq
            del wq
            k = x @ dequantized(a["wk"]["weight"])
            v = x @ dequantized(a["wv"]["weight"])
            att = torch.empty_like(q)
            for s, n in spans:
                att[s:s + n] = causal_attention(
                    rope_halves(q[s:s + n].view(n, H, hd), cos[:n], sin[:n]),
                    rope_halves(k[s:s + n].view(n, Hkv, hd), cos[:n],
                                sin[:n]),
                    v[s:s + n].view(n, Hkv, hd))
            del q, k, v
            wo = dequantized(a["wo"]["weight"])
            attn_out = att @ wo
            del att, wo
            x = layer_norm(h, lw["ln_mlp"], eps)
            up = dequantized(lw["mlp"]["dense_h_to_4h"]["weight"])
            y = F.gelu(x @ up)
            del up, x
            down = dequantized(lw["mlp"]["dense_4h_to_h"]["weight"])
            h = h + attn_out + y @ down
            del down, y, attn_out, lw
        head = dequantized(rest["output"]["weight"])
        out = []
        for r, (s, n) in zip(requests, spans):
            G = len(r["served"])
            x = layer_norm(h[s + n - G: s + n], rest["ln_f"], eps)
            out.append(x @ head)
        return out
