"""The depth-scaled draw of the A8 numerics gates and the JAX scripts'
decision rule made concrete (scripts/torch_w4a8_accuracy.py
``depth_scaled_llama``, ``noise_floor_rule``, ``fitness``; the dense arm of
both decoder scripts) against the JAX scripts on the CPU, at a tiny width:
a 4-layer decoder of dim 128 (2 heads of 64) over a vocabulary of 256, a
prompt of 8 ids and 4 forced steps, float32.

- The draw's int4 tree is the JAX quantizer's: the dense tree carried to
  numpy (``checkpoint/bridge.py``) and quantized by
  ``a3vlm_tpu.quant.quantize_params`` gives the port's codes and scales
  byte for byte.
- The dense, exact int4 and A8 arms of each port script's ``run_arms`` on
  the draw's trees, carried into JAX, against the JAX script's
  ``make_run``: logits to 1e-4 relative (the same weights; the sums differ
  in order). At this size the prompt's M (2 x 8) is a decode-sized one,
  so in the W4A8 arm both packages send the prefill through the A8 route
  too; the W8A8 threshold is lowered to the prompt in both.
- ``noise_floor_rule``'s figures on the port's arrays equal the rule's
  arithmetic written out on the JAX arrays.
- The rule and ``fitness`` on hand-made logits.
- The depth sweep (scripts/torch_depth_sweep.py) gives, at each depth, the
  gate's figures on that depth's own draw.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu import quant as jquant
from a3vlm_tpu.config import ModelArgs as JArgs
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.ops import quant_matmul as jqm
from a3vlm_tpu_torch.checkpoint.bridge import params_to_numpy
from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.ops import quant_matmul as tqm
from scripts import torch_depth_sweep as tsweep
from scripts import torch_w4a8_accuracy as tw4a8
from scripts import torch_w8a8_prefill_accuracy as tw8a8
from scripts import w4a8_accuracy as jw4a8

# the JAX prefill script imports its sibling by its bare name
sys.modules.setdefault("w4a8_accuracy", jw4a8)
from scripts import w8a8_prefill_accuracy as jw8a8  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-4
TINY = dict(dim=128, n_layers=4, n_heads=2, n_kv_heads=2, vocab_size=256,
            multiple_of=128)
B, PROMPT, STEPS = 2, 8, 4


@pytest.fixture
def one_device(monkeypatch):
    """The JAX dispatchers read their mode flags on the single-device path
    only; the tests run on a forced 8-device CPU mesh, so pin the count the
    dispatchers see, as the JAX package's own tests do."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])
    jax.clear_caches()
    yield
    jax.clear_caches()


def _to_jax(tree):
    """``params_to_numpy``'s tree as the JAX package's: int4 leaves as
    ``QuantizedWeight``, layers unstacked."""
    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if hasattr(x, "q"):
            return jquant.QuantizedWeight(
                jnp.asarray(x.q), jnp.asarray(x.scale), bits=x.bits,
                group=x.group, in_dim=x.in_dim)
        return jnp.asarray(x)

    return jllama.unstack_layers(leaf(tree))


@pytest.fixture(scope="module")
def draw():
    kw = dict(TINY, max_batch_size=B, max_seq_len=PROMPT + STEPS + 8)
    targs = ModelArgs(**kw)
    dense, int4 = tw4a8.depth_scaled_llama(targs, 0, "cpu",
                                           dtype=torch.float32)
    prompt, stream = tw4a8.teacher_forced_ids(0, B, PROMPT, STEPS,
                                              high=TINY["vocab_size"])
    dense_np, int4_np = params_to_numpy(dense), params_to_numpy(int4)
    return {"targs": targs, "jargs": JArgs(**kw), "dense": dense,
            "int4": int4, "dense_np": dense_np, "int4_np": int4_np,
            "jdense": _to_jax(dense_np), "jint4": _to_jax(int4_np),
            "prompt": prompt, "stream": stream}


def test_draw_is_the_jax_quantizers_int4_tree(draw):
    """Every linear of the draw quantized alike by both packages (codes,
    scales, geometry); the embeddings and norms are the dense tree's; the
    residual writers carry the depth scale."""
    want = jquant.quantize_params(draw["dense_np"], bits=4)
    got = draw["int4_np"]
    L = TINY["n_layers"]
    for sub, names in (("attention", ("wq", "wk", "wv", "wo")),
                       ("feed_forward", ("w1", "w2", "w3"))):
        for n in names:
            g = got["layers"][sub][n]["weight"]
            w = want["layers"][sub][n]["weight"]
            np.testing.assert_array_equal(g.q, np.asarray(w.q))
            np.testing.assert_array_equal(g.scale, np.asarray(w.scale))
            assert (g.bits, g.group, g.in_dim) == (4, w.group, w.in_dim)
            std = draw["dense_np"]["layers"][sub][n]["weight"].std()
            scale = (2 * L) ** -0.5 if n in ("wo", "w2") else 1.0
            assert abs(std / (0.02 * scale) - 1) < 0.05, (n, std)
    g, w = got["output"]["weight"], want["output"]["weight"]
    np.testing.assert_array_equal(g.q, np.asarray(w.q))
    np.testing.assert_array_equal(g.scale, np.asarray(w.scale))
    for name in ("tok_embeddings", "norm"):
        np.testing.assert_array_equal(got[name]["weight"],
                                      draw["dense_np"][name]["weight"])
    assert draw["int4"]["tok_embeddings"]["weight"] is \
        draw["dense"]["tok_embeddings"]["weight"]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _jax_arms(monkeypatch, d, script, flag):
    """The JAX script's ``make_run`` on the exact int4 tree with ``flag``
    off (False) and on (True), and on the dense tree (``"dense"``)."""
    prompt = jnp.asarray(d["prompt"], jnp.int32)
    stream = jnp.asarray(d["stream"], jnp.int32)
    outs = {}
    for key, tree, on in ((False, d["jint4"], False),
                          (True, d["jint4"], True),
                          ("dense", d["jdense"], False)):
        monkeypatch.setattr(jqm, flag, on)
        jax.clear_caches()
        run = script.make_run(d["jargs"], prompt.shape[1], stream.shape[1])
        outs[key] = jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), run(tree, prompt, stream))
    return outs


def _rule_arithmetic(dense, exact, mode):
    """``noise_floor_rule``'s figures written out on [steps, B, V] (or
    [B, V]) arrays."""
    def rel(ref, got):
        ref = ref.reshape(-1, ref.shape[-2] * ref.shape[-1])
        got = got.reshape(ref.shape)
        return (np.linalg.norm(got - ref, axis=1)
                / np.linalg.norm(ref, axis=1)).mean()

    return {"e_int4": rel(dense, exact), "e_mode": rel(exact, mode),
            "agreement_int4": (exact.argmax(-1) == dense.argmax(-1)).mean(),
            "agreement_mode": (mode.argmax(-1) == exact.argmax(-1)).mean()}


def _check_rule(rule, want):
    for k, v in want.items():
        assert abs(rule[k] - v) <= 1e-6, (k, rule[k], v)
    assert rule["ratio"] == rule["e_mode"] / rule["e_int4"]
    assert rule["pass"] == all(rule["checks"].values())


def test_w4a8_arms_match_jax(monkeypatch, one_device, draw):
    d = draw
    want = _jax_arms(monkeypatch, d, jw4a8, "W4A8_DECODE")
    got = tw4a8.run_arms(d["int4"], d["targs"], torch.tensor(d["prompt"]),
                         torch.tensor(d["stream"]), dense=d["dense"])
    assert not tqm.W4A8_DECODE  # restored
    assert set(got) == {False, True, "dense"}
    for key in got:
        assert got[key].shape == (STEPS, B, TINY["vocab_size"])
        _close(got[key], want[key])
    # the three arms differ: int4 moves the logits, the mode engaged
    assert not np.array_equal(got[False], got["dense"])
    assert not np.array_equal(got[False], got[True])

    rule = tw4a8.noise_floor_rule(got["dense"], got[False], got[True])
    _check_rule(rule, _rule_arithmetic(want["dense"], want[False],
                                       want[True]))
    flips = int((got[True].argmax(-1) != got[False].argmax(-1)).sum())
    assert len(rule["disagreements"]) == flips


def test_w8a8_prefill_arms_match_jax(monkeypatch, one_device, draw):
    d = draw
    for mod in (jqm, tqm):
        monkeypatch.setattr(mod, "W8A8_PREFILL_MIN_M", PROMPT)
    want = _jax_arms(monkeypatch, d, jw8a8, "W8A8_PREFILL")
    got = tw8a8.run_arms(d["int4"], d["targs"], torch.tensor(d["prompt"]),
                         torch.tensor(d["stream"]), dense=d["dense"])
    assert not tqm.W8A8_PREFILL
    for key in (False, True, "dense"):
        for i in range(2):
            _close(got[key][i], want[key][i])
    assert not np.array_equal(got[False][0], got[True][0])
    assert not np.array_equal(got[False][0], got["dense"][0])

    rules = tw8a8.rule_metrics(got)
    for i, name in enumerate(tw8a8.LOGITS):
        _check_rule(rules[name], _rule_arithmetic(
            want["dense"][i], want[False][i], want[True][i]))


def _logits(seed, shape=(8, 2, 64)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _swap_top2(x, step, row, by):
    """``x`` with the top-1 logit at (step, row) lowered and the top-2
    raised, each by ``by`` times their gap; returns it and the gap."""
    x = x.copy()
    top = np.argsort(x[step, row])[-2:]
    gap = x[step, row, top[1]] - x[step, row, top[0]]
    x[step, row, top[1]] -= by * gap
    x[step, row, top[0]] += by * gap
    return x, gap


@pytest.mark.parametrize("case", ["pass", "ratio", "agreement",
                                  "past_near_tie"])
def test_noise_floor_rule_on_hand_made_logits(case):
    """Each check of the rule fails alone: the mode's error over a quarter
    of int4's, an agreement below int4's with dense, and a flip by a move
    smaller than the top-1/top-2 gap."""
    dense = _logits(0)
    exact = dense + 0.3 * _logits(1)  # int4 with flips against dense
    if case == "agreement":
        exact = 1.2 * dense  # int4 agrees with dense everywhere
    mode = {"pass": 1.01 * exact, "ratio": 1.2 * exact}.get(case)
    if case == "agreement":
        mode, gap = _swap_top2(exact, 3, 1, 1.01)  # a flip at a near-tie
    if case == "past_near_tie":
        mode, gap = _swap_top2(exact, 3, 1, 0.75)  # moved 0.75 x the gap
    rule = tw4a8.noise_floor_rule(dense, exact, mode)
    _check_rule(rule, _rule_arithmetic(dense, exact, mode))
    failed = {k for k, ok in rule["checks"].items() if not ok}
    assert failed == ({"ratio": {"ratio"}, "agreement": {"agreement"},
                       "past_near_tie": {"near_ties"}}.get(case, set()))
    assert rule["pass"] == (case == "pass")
    if case in ("agreement", "past_near_tie"):
        (flip,) = rule["disagreements"]
        assert (flip["step"], flip["row"]) == (3, 1)
        assert flip["near_tie"] == (case == "agreement")
        np.testing.assert_allclose(flip["gap"], gap, rtol=1e-5)


@pytest.mark.parametrize("case", ["pass", "collapsed", "offset",
                                  "control_rel_rms", "control_agreement",
                                  "control_past_near_tie"])
def test_fitness_on_hand_made_logits(case):
    """256 positions over 512 ids: independent rows pass; one output for
    every position fails the distinct ids, a large row mean the offset; a
    control too far from the exact arm fails on its rel RMS, one that
    flips many positions by near-ties on its agreement, and one flip past
    a near-tie fails alone."""
    exact = _logits(2, (64, 4, 512))
    if case == "collapsed":
        exact = 1e-3 * exact + _logits(3, (512,))
    if case == "offset":
        exact = exact + 5.0
    control = 1.01 * exact
    if case == "control_rel_rms":
        control = 1.05 * exact
    if case == "control_agreement":
        for i in range(16):  # 16 of 256 positions flipped at near-ties
            control, _ = _swap_top2(control, i, 0, 1.01)
    if case == "control_past_near_tie":
        control, _ = _swap_top2(exact, 5, 2, 0.75)
    fit = tw4a8.fitness(exact, {"c": control})
    failed = {k for k, ok in fit["checks"].items() if not ok}
    assert failed == ({"collapsed": {"distinct_argmax"},
                       "offset": {"offset_to_std"}}.get(
                           case, set() if case == "pass" else {"c"}))
    assert fit["pass"] == (case == "pass")
    assert fit["positions"] == 256
    c = fit["controls"]["c"]
    assert c["past_near_tie"] == (case == "control_past_near_tie")
    np.testing.assert_allclose(
        c["rel_rms_mean"], tw4a8.step_rel_rms(exact, control).mean())


def test_depth_sweep_rows_are_the_gates(draw):
    """Each depth of the sweep is ``depth_scaled_gate`` on that depth's
    own draw: the 4-layer row equals the gate on the fixture's draw, the
    2-layer row is another draw."""
    d = draw
    prompt, stream = torch.tensor(d["prompt"]), torch.tensor(d["stream"])
    kw = dict(TINY, max_batch_size=B, max_seq_len=PROMPT + STEPS + 8)
    rows = list(tsweep.sweep(
        lambda n: ModelArgs(**{**kw, "n_layers": n}), [2, 4], prompt,
        stream, dtype=torch.float32))
    assert [r["n_layers"] for r in rows] == [2, 4]
    gate = tw4a8.depth_scaled_gate(d["dense"], d["int4"], d["targs"],
                                   prompt, stream)
    want = gate["fitness"]
    got = rows[1]["fitness"]
    assert set(got["controls"]) == {"v3", "fuse_ffn_down", "float32_plain"}
    for name, c in want["controls"].items():
        assert got["controls"][name] == c
    assert got["distinct_argmax"] == want["distinct_argmax"]
    for k in ("e_int4", "e_mode", "agreement_int4", "agreement_mode"):
        assert rows[1]["rule"][k] == gate["rule"][k]
    assert rows[1]["rule"]["disagreements"] == len(
        gate["rule"]["disagreements"])
    assert rows[1]["pass"] == gate["pass"]
    assert rows[0]["rule"]["e_int4"] != rows[1]["rule"]["e_int4"]
    table = tsweep.summary(rows)
    assert set(table) == {2, 4}
    assert table[4]["e_int4"] == gate["rule"]["e_int4"]
    assert table[4]["v3"] == [want["controls"]["v3"]["rel_rms_mean"],
                              want["controls"]["v3"]["argmax_agreement"]]
