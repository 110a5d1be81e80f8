"""Numerics gate of the PyTorch port's W4A8 decode mode
(``a3vlm_tpu_torch.ops.quant_matmul.W4A8_DECODE``, K7 and its row
quantizer), counterpart of scripts/w4a8_accuracy.py.

One matmul's error is bounded by the kernel tests; this script measures
how the per-row int8 rounding of the activations compounds through a
full-depth decode stack (the 7B's 32 layers, or with ``--shape 13b`` the
13B decoder of ``Ens5Config``: dim 5120, 40 layers). The same token stream
is teacher-forced through every arm: a 32-id prompt (M = batch x 32 rows,
the exact tiled kernel under either flag), then 64 decode steps with
``W4A8_DECODE`` off, then on (the flag is read at every call).

Two draws of random content (constant fabricated weights make every
logit equal):

- ``--draw jax`` (the default, ``random_llama_int4``): the JAX script's
  draw, the parity run with it. Its codes are uniform over the packed
  bytes, so each nibble has a mean of -0.5 and every weight a bias of
  about a ninth of its spread; through the depth the hidden state
  collapses onto one direction whatever the input (``distinct_argmax`` 1
  or 2, ``offset_to_std`` far above 1), and a change of rounding can flip
  a row's sign at a step (~100% relative RMS there). On the card the W4A8
  arm is also held against its plain twin (``plain_twin``: the same W4A8
  math through the plain versions), which shows what the kernels add at
  depth beyond the mode's own rounding.
- ``--draw depth_scaled`` (``depth_scaled_llama``): the JAX script's
  recipe with dense bf16 linears N(0, 0.02^2), ``wo`` and ``w2`` scaled
  by 1/sqrt(2 L), quantized to int4 by the port's own
  ``quant.quantize_params`` (the quantizer behind ``MetaModel.quantize``).
  The dense tree is kept, so a third arm, the dense bf16 run, measures
  int4's own error: the JAX script's decision rule (ship the mode if its
  argmax agreement is ~100% and its logit error stays in the int4
  noise floor) made concrete as ``noise_floor_rule``. ``fitness``
  checks on the exact arm that the draw is an instrument: not collapsed
  (many distinct greedy ids, row means small against their spread) and
  not chaotic (three exact changes of rounding, ``control_arms``, move
  the logits little).

Reports per-step logit relative RMS (mean, max and its step, median), the
max abs logit difference, the exact logits' std, the mean top-1/top-2
margin, greedy argmax agreement, each argmax disagreement with the exact
arm's top-1/top-2 gap there against that step's max abs logit difference
(a disagreement is a near-tie when the gap is no larger), and how much the
exact logits depend on the input (``distinct_argmax``: the distinct greedy
ids over all positions; ``offset_to_std``: a row's mean logit over its
spread, averaged).

    python scripts/torch_w4a8_accuracy.py [--shape 7b|13b]
        [--draw jax|depth_scaled]
        [--steps 64] [--batch 4] [--prompt 32] [--seed 0] [--controls]
        [--device cuda]

Prints one JSON line of the metrics; on the depth-scaled draw exits 1
unless the draw is fit and the mode passes the rule. The weights are made
on the device from a ``torch.Generator`` (the 7B's depth-scaled draw:
13.5 GB dense and 3.5 GB packed; the JAX draw holds no dense tree).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from a3vlm_tpu_torch.config import ModelArgs  # noqa: E402
from a3vlm_tpu_torch.models import llama  # noqa: E402
from a3vlm_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from a3vlm_tpu_torch.quant import (  # noqa: E402
    QuantizedWeight,
    int4_geometry,
    quantize_params,
    tree_map,
)

# the depth-scaled draw is an instrument when its exact arm gives distinct
# greedy ids at half the positions or more and row means at most their
# spread (not collapsed), and each exact change of rounding
# (``control_arms``) stays within this mean rel RMS and agreement, every
# flip at a near-tie (not chaotic)
FIT_MAX_OFFSET_TO_STD = 1.0
FIT_MAX_CONTROL_REL_RMS = 0.03
FIT_MIN_CONTROL_AGREEMENT = 0.95
# the noise-floor rule: a mode's mean rel RMS against exact int4 at most
# this share of exact int4's own against the dense arm
RULE_MAX_RATIO = 0.25


def seven_b_args(**kw) -> ModelArgs:
    """LLaMA-2-7B's decoder shape (bench.py:126-134)."""
    base = dict(
        dim=4096, n_layers=32, n_heads=32, n_kv_heads=32, vocab_size=32000,
        multiple_of=256, max_batch_size=16, max_seq_len=256,
    )
    base.update(kw)
    return ModelArgs(**base)


def thirteen_b_args(**kw) -> ModelArgs:
    """The 13B decoder of ``Ens5Config`` (dim 5120, 40 layers, 40 heads,
    ffn 13824) over a 32000-id vocabulary."""
    base = dict(vocab_size=32000, max_batch_size=16, max_seq_len=256)
    base.update(kw)
    return ModelArgs(**base)


SHAPES = {"7b": seven_b_args, "13b": thirteen_b_args}


def random_llama_int4(args: ModelArgs, seed: int = 0,
                      device: str | torch.device = "cuda") -> dict:
    """Decoder params of ``args``' shape with random CONTENT
    (w4a8_accuracy.py:37-96), made on ``device`` from a generator seeded
    with ``seed``: every linear int4 in ``int4_geometry``'s layout (the
    tree ``checkpoint/bridge.py`` carries), codes uniform over the packed
    bytes (nibbles over [-8, 7], mean -0.5, std 4.6) and group scales
    U[3e-3, 6e-3]; bf16 embeddings N(0, 1) x 0.02; unit bf16 norms;
    layers as a per-layer list."""
    D, V = args.dim, args.vocab_size
    H, Hkv, hd, F = args.n_heads, args.kv_heads, args.head_dim, \
        args.ffn_hidden_dim
    gen = torch.Generator(device=device).manual_seed(seed)

    def qw(in_dim, out_dim):
        pad_in, g = int4_geometry(in_dim)
        q = torch.randint(-128, 128, (pad_in // 2, out_dim), generator=gen,
                          device=device, dtype=torch.int8)
        # int4 codes of std ~4.6; scale ~4.5e-3 -> w std ~0.02
        s = torch.empty((pad_in // g, out_dim), device=device).uniform_(
            3e-3, 6e-3, generator=gen)
        return QuantizedWeight(q, s, bits=4, group=g, in_dim=in_dim)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    layers = [{
        "attention": {
            "wq": {"weight": qw(D, H * hd)},
            "wk": {"weight": qw(D, Hkv * hd)},
            "wv": {"weight": qw(D, Hkv * hd)},
            "wo": {"weight": qw(H * hd, D)},
        },
        "feed_forward": {
            "w1": {"weight": qw(D, F)},
            "w2": {"weight": qw(F, D)},
            "w3": {"weight": qw(D, F)},
        },
        "attention_norm": {"weight": ones(D)},
        "ffn_norm": {"weight": ones(D)},
    } for _ in range(args.n_layers)]
    emb = torch.randn((V, D), generator=gen, device=device) * 0.02
    return {
        "tok_embeddings": {"weight": emb.to(torch.bfloat16)},
        "layers": layers,
        "norm": {"weight": ones(D)},
        "output": {"weight": qw(D, V)},
    }


def depth_scaled_llama(args: ModelArgs, seed: int = 0,
                       device: str | torch.device = "cuda",
                       dtype: torch.dtype = torch.bfloat16):
    """Decoder params of ``args``' shape with random content, made on
    ``device`` from a generator seeded with ``seed``: ``random_llama_int4``'s
    recipe with every linear dense, N(0, 1) x 0.02 in ``dtype``, ``wo`` and
    ``w2`` also scaled by 1/sqrt(2 L); embeddings N(0, 1) x 0.02,
    unit norms, layers as a per-layer list. Returns ``(dense, int4)``: the
    dense tree, and its int4 form by ``quantize_params(bits=4)`` (an int4
    head; the embeddings and norms are the dense tree's tensors)."""
    D, V, L = args.dim, args.vocab_size, args.n_layers
    H, Hkv, hd, F = args.n_heads, args.kv_heads, args.head_dim, \
        args.ffn_hidden_dim
    gen = torch.Generator(device=device).manual_seed(seed)
    res = (2 * L) ** -0.5

    def w(in_dim, out_dim, scale=1.0):
        x = torch.randn((in_dim, out_dim), generator=gen, device=device)
        return (x * (0.02 * scale)).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    dense = {
        "tok_embeddings": {"weight": w(V, D)},
        "layers": [{
            "attention": {
                "wq": {"weight": w(D, H * hd)},
                "wk": {"weight": w(D, Hkv * hd)},
                "wv": {"weight": w(D, Hkv * hd)},
                "wo": {"weight": w(H * hd, D, res)},
            },
            "feed_forward": {
                "w1": {"weight": w(D, F)},
                "w2": {"weight": w(F, D, res)},
                "w3": {"weight": w(D, F)},
            },
            "attention_norm": {"weight": ones(D)},
            "ffn_norm": {"weight": ones(D)},
        } for _ in range(L)],
        "norm": {"weight": ones(D)},
        "output": {"weight": w(D, V)},
    }
    # quantize a copy of the containers: the dense leaves stay in ``dense``
    return dense, quantize_params(tree_map(lambda t: t, dense), bits=4)


def teacher_forced_ids(seed: int, batch: int, prompt: int, steps: int,
                       high: int = 30000):
    """The prompt [batch, prompt] and the forced stream [batch, steps] of
    ids in [5, high), from numpy's generator seeded with ``seed``
    (w4a8_accuracy.py:132-138)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(5, high, (batch, prompt)),
            rng.integers(5, high, (batch, steps)))


def make_run(args: ModelArgs, prompt_len: int, steps: int,
             cache_dtype: torch.dtype = torch.bfloat16, impl: str = "auto"):
    """The teacher-forced run (w4a8_accuracy.py:99-117): ``run(params,
    prompt, stream)`` prefills ``prompt`` [B, prompt_len] into a fresh
    cache, then feeds ``stream`` [B, steps] one id a step and returns every
    step's logits, float32 [steps, B, V]. The quantized-matmul flags are
    read at every call."""

    @torch.inference_mode()
    def run(params, prompt: torch.Tensor, stream: torch.Tensor):
        B = prompt.shape[0]
        cache = llama.KVCache.create(args, B, dtype=cache_dtype,
                                     device=prompt.device)
        _, cache, _ = llama.prefill(params, args, cache, prompt, impl=impl)
        out = torch.zeros((steps, B, args.vocab_size), dtype=torch.float32,
                          device=prompt.device)
        for i in range(steps):
            out[i], cache = llama.decode_step(params, args, cache,
                                              stream[:, i:i + 1],
                                              prompt_len + i, impl=impl)
        return out

    return run


def near_ties(exact: np.ndarray, got: np.ndarray) -> list[dict]:
    """Every argmax disagreement of ``got`` [..., B, V] with ``exact``
    (leading axes the steps; a 2-D slab is one step): its index, the exact
    arm's top-1/top-2 gap there and that step's max abs logit difference.
    A disagreement is a near-tie when the gap is no larger than that
    difference (the gap rule of ``chip_smoke.py``'s phases 9 and 11)."""
    exact3 = exact.reshape(-1, *exact.shape[-2:])
    got3 = got.reshape(-1, *got.shape[-2:])
    out = []
    for step, (e, g) in enumerate(zip(exact3, got3)):
        step_diff = float(np.abs(g - e).max())
        for row in np.nonzero(e.argmax(-1) != g.argmax(-1))[0]:
            top = np.sort(e[row])[-2:]
            gap = float(top[1] - top[0])
            out.append({"step": step, "row": int(row), "gap": gap,
                        "step_max_abs_diff": step_diff,
                        "near_tie": gap <= step_diff})
    return out


def step_rel_rms(exact: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Per-step relative RMS of ``got`` against ``exact`` [..., B, V] over
    each step's [B, V] slab (leading axes the steps; a 2-D slab is one
    step)."""
    e = exact.reshape(-1, exact.shape[-2] * exact.shape[-1])
    g = got.reshape(e.shape)
    return np.linalg.norm(g - e, axis=1) / np.linalg.norm(e, axis=1)


def agreement(a: np.ndarray, b: np.ndarray) -> float:
    """The share of positions whose greedy ids agree."""
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def metrics(exact: np.ndarray, got: np.ndarray) -> dict:
    """w4a8_accuracy.py:148-165's numbers of two [steps, B, V] logit
    arrays: per-step relative RMS over the [B, V] slab (mean, max, the
    step of the max; and the median), max abs difference, the exact logits' std, their
    mean top-1/top-2 margin, greedy argmax agreement; and ``near_ties``."""
    diff = got - exact
    rel = step_rel_rms(exact, got)
    agree = agreement(got, exact)
    # margin context: how far apart are top1/top2 in the exact logits?
    srt = np.sort(exact, axis=-1)
    margin = (srt[..., -1] - srt[..., -2]).mean()
    return {
        "rel_rms_mean": float(rel.mean()),
        "rel_rms_max": float(rel.max()),
        "rel_rms_max_step": int(rel.argmax()),
        "rel_rms_median": float(np.median(rel)),
        "max_abs_diff": float(np.abs(diff).max()),
        "exact_std": float(exact.std()),
        "top2_margin_mean": float(margin),
        "argmax_agreement": float(agree),
        "disagreements": near_ties(exact, got),
        **content_dependence(exact),
    }


def content_dependence(exact: np.ndarray) -> dict:
    """How much the exact logits [..., V] depend on the input: the distinct
    greedy ids over all positions, and a row's mean logit over its spread
    (averaged). A model whose hidden state has collapsed onto one
    direction gives 1 or 2 ids and a ratio far above 1."""
    rows = exact.reshape(-1, exact.shape[-1])
    return {
        "distinct_argmax": int(np.unique(rows.argmax(-1)).size),
        "offset_to_std": float(np.abs(rows.mean(-1)).mean()
                               / rows.std(-1).mean()),
    }


def run_arms(params, args: ModelArgs, prompt: torch.Tensor,
             stream: torch.Tensor, run=None, dense=None) -> dict:
    """The teacher-forced run with ``W4A8_DECODE`` off (False) and on
    (True), each arm's logits as float32 numpy, and with ``dense`` (the
    dense tree of ``params``) a third arm ``"dense"``, run with the flag
    off; the flag is restored after."""
    run = run or make_run(args, prompt.shape[1], stream.shape[1])
    saved = qm.W4A8_DECODE
    outs = {}
    try:
        for w4a8 in (False, True):
            qm.W4A8_DECODE = w4a8
            outs[w4a8] = run(params, prompt, stream).cpu().numpy()
        if dense is not None:
            qm.W4A8_DECODE = False
            outs["dense"] = run(dense, prompt, stream).cpu().numpy()
    finally:
        qm.W4A8_DECODE = saved
    return outs


def noise_floor_rule(dense: np.ndarray, exact: np.ndarray,
                     mode: np.ndarray) -> dict:
    """The JAX scripts' decision rule made concrete, on the logits
    [..., B, V] of the dense, exact int4 and mode arms: ``e_int4`` the
    mean per-step rel RMS of exact int4 against dense, ``e_mode`` the same
    of the mode against exact int4, both argmax agreements, and each
    disagreement of the mode with exact int4 (``near_ties``). The mode
    passes when ``e_mode <= RULE_MAX_RATIO * e_int4``, it agrees with
    exact int4 at least as often as exact int4 with dense, and every
    disagreement is a near-tie."""
    e_int4 = float(step_rel_rms(dense, exact).mean())
    e_mode = float(step_rel_rms(exact, mode).mean())
    agree_int4 = agreement(exact, dense)
    agree_mode = agreement(mode, exact)
    flips = near_ties(exact, mode)
    checks = {"ratio": e_mode <= RULE_MAX_RATIO * e_int4,
              "agreement": agree_mode >= agree_int4,
              "near_ties": all(t["near_tie"] for t in flips)}
    return {"e_int4": e_int4, "e_mode": e_mode, "ratio": e_mode / e_int4,
            "agreement_int4": agree_int4, "agreement_mode": agree_mode,
            "disagreements": flips, "checks": checks,
            "pass": all(checks.values())}


def fitness(exact: np.ndarray, controls: dict) -> dict:
    """Whether a draw is an instrument, on its exact arm's logits
    [..., B, V] and ``control_arms``' logits: not collapsed
    (``content_dependence`` gives distinct greedy ids at half the
    positions or more, and ``offset_to_std`` at most
    ``FIT_MAX_OFFSET_TO_STD``) and not chaotic (each control's mean rel
    RMS against the exact arm at most ``FIT_MAX_CONTROL_REL_RMS``, its
    agreement at least ``FIT_MIN_CONTROL_AGREEMENT``, every disagreement
    a near-tie)."""
    cd = content_dependence(exact)
    positions = exact.size // exact.shape[-1]
    checks = {"distinct_argmax": 2 * cd["distinct_argmax"] >= positions,
              "offset_to_std": cd["offset_to_std"] <= FIT_MAX_OFFSET_TO_STD}
    ctl = {}
    for name, x in controls.items():
        ties = near_ties(exact, x)
        ctl[name] = {"rel_rms_mean": float(step_rel_rms(exact, x).mean()),
                     "argmax_agreement": agreement(x, exact),
                     "disagreements": len(ties),
                     "past_near_tie": sum(not t["near_tie"] for t in ties)}
        checks[name] = (ctl[name]["rel_rms_mean"] <= FIT_MAX_CONTROL_REL_RMS
                        and ctl[name]["argmax_agreement"]
                        >= FIT_MIN_CONTROL_AGREEMENT
                        and not ctl[name]["past_near_tie"])
    return {**cd, "positions": positions, "controls": ctl, "checks": checks,
            "pass": all(checks.values())}


def plain_twin(params, args: ModelArgs, prompt: torch.Tensor,
               stream: torch.Tensor) -> np.ndarray:
    """The W4A8 arm's run through the plain versions (``impl="plain"``,
    ``W4A8_DECODE`` on): the mode's math with no kernel, its logits as
    float32 numpy; the flag is restored after. On CPU tensors it is the
    W4A8 arm itself."""
    saved = qm.W4A8_DECODE
    qm.W4A8_DECODE = True
    try:
        return make_run(args, prompt.shape[1], stream.shape[1],
                        impl="plain")(params, prompt, stream).cpu().numpy()
    finally:
        qm.W4A8_DECODE = saved


def control_arms(params, args: ModelArgs, prompt: torch.Tensor,
                 stream: torch.Tensor) -> dict:
    """The exact run under changes of rounding that keep it exact: the v3
    int4 kernel (the group scale applied after the product), the GLU-fused
    FFN tail, and the plain path with the dense leaves in float32. Each
    arm's logits as float32 numpy; the flags are restored after."""
    from a3vlm_tpu_torch.quant import tree_map

    run = make_run(args, prompt.shape[1], stream.shape[1])
    outs = {}
    for name, mod, flag, value in (
            ("v3", qm, "_AUTO_VARIANT", "v3"),
            ("fuse_ffn_down", llama, "FUSE_FFN_DOWN", True)):
        saved = getattr(mod, flag)
        setattr(mod, flag, value)
        try:
            outs[name] = run(params, prompt, stream).cpu().numpy()
        finally:
            setattr(mod, flag, saved)
    f32 = tree_map(lambda t: t if isinstance(t, QuantizedWeight)
                   else t.float(), params)
    outs["float32_plain"] = make_run(
        args, prompt.shape[1], stream.shape[1], impl="plain")(
            f32, prompt, stream).cpu().numpy()
    return outs


def brief(m: dict) -> dict:
    """``metrics`` with the disagreements counted, not listed."""
    ties = m["disagreements"]
    return {**{k: v for k, v in m.items() if k != "disagreements"},
            "disagreements": len(ties),
            "past_near_tie": sum(not t["near_tie"] for t in ties)}


def depth_scaled_gate(dense, params, args: ModelArgs,
                      prompt: torch.Tensor, stream: torch.Tensor) -> dict:
    """The W4A8 gate on a depth-scaled draw: the exact, W4A8 and dense
    arms and ``control_arms``; ``fitness`` of the draw (whether the
    rule's figures measure the mode), ``noise_floor_rule`` and the W4A8
    arm's ``metrics`` against the exact arm. ``"pass"``: the draw is fit
    and the mode passes the rule."""
    outs = run_arms(params, args, prompt, stream, dense=dense)
    fit = fitness(outs[False], control_arms(params, args, prompt, stream))
    rule = noise_floor_rule(outs["dense"], outs[False], outs[True])
    return {"fitness": fit, "rule": rule,
            "w4a8_decode": metrics(outs[False], outs[True]),
            "pass": fit["pass"] and rule["pass"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="7b")
    ap.add_argument("--draw", choices=("jax", "depth_scaled"),
                    default="jax")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--controls", action="store_true",
                    help="jax draw: also run the exact path under three "
                    "exact changes of rounding (control_arms), each held "
                    "against the exact arm like the W4A8 arm")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    margs = SHAPES[a.shape](max_batch_size=a.batch,
                            max_seq_len=a.prompt + a.steps + 8)
    prompt, stream = (torch.as_tensor(t, device=a.device) for t in
                      teacher_forced_ids(a.seed, a.batch, a.prompt, a.steps))
    print(f"building the {a.shape} ({a.draw} draw) on the device...",
          flush=True)
    if a.draw == "depth_scaled":
        dense, params = depth_scaled_llama(margs, a.seed, a.device)
        out = depth_scaled_gate(dense, params, margs, prompt, stream)
        out = {k: brief(v) if isinstance(v, dict) and "disagreements" in v
               else v for k, v in out.items()}
        print(json.dumps(out))
        return 0 if out["pass"] else 1
    params = random_llama_int4(margs, seed=a.seed, device=a.device)
    outs = run_arms(params, margs, prompt, stream)
    out = {"w4a8_decode": metrics(outs[False], outs[True])}
    if a.device != "cpu":
        out["w4a8_kernels_vs_plain"] = metrics(
            outs[True], plain_twin(params, margs, prompt, stream))
    if a.controls:
        out = {k: brief(v) for k, v in out.items()}
        out["controls"] = {
            name: brief(metrics(outs[False], x)) for name, x in
            control_arms(params, margs, prompt, stream).items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
