"""Grammar-constrained decoding: FSM token masking over the triad codecs.

The reference tolerates malformed answers after the fact — digit-soup
cleanup, decimal re-insertion, magnitude guessing
(eval_affordance_v2.py:206-232, mirrored in codecs/repair.py) — and still
counts a parse failure whenever repair can't recover a box. Constrained
decoding makes malformed output impossible instead: a character-level DFA
compiled from the answer grammar is lifted to a TOKEN-level transition
table over the tokenizer, and each decode step masks the logits to tokens
whose whole piece keeps the DFA alive. EOS is legal only in accepting
states, so the model can neither break the format nor stop mid-answer.

Design: the lifted table is a dense ``[S, V] int32`` array (placed on the
device by the consumer, built once per grammar+tokenizer); per step the
sampler gathers one row per sequence (``table[state]`` -> [B, V] mask) and
carries ``state [B]`` through the generation loop on the device, with no
host round trip, compatible with greedy and top-p sampling alike.

Grammar combinators (``Lit/Cls/Seq/Alt/Rep/Opt/Star``) build a Thompson
NFA; subset construction over the explicit-character alphabet (plus one
OTHER symbol for negated classes) yields the DFA. ``compile_grammar``
validates liveness under the actual tokenizer: every reachable
non-accepting state must admit at least one token, otherwise the grammar
cannot be decoded with this vocabulary and compilation fails loudly.

Answer grammars for the A3VLM task streams live at the bottom
(``rotated_box_grammar`` etc.), matching the byte formats of
codecs/triad.py (vqa_task_construction.py:121-151, 163-187, 441-491).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Regex combinators -> Thompson NFA
# ---------------------------------------------------------------------------

_DIGITS = "0123456789"


class _Node:
    pass


@dataclass(frozen=True)
class Lit(_Node):
    s: str


@dataclass(frozen=True)
class Cls(_Node):
    chars: str
    negate: bool = False


@dataclass(frozen=True)
class Seq(_Node):
    parts: tuple

    def __init__(self, *parts):
        object.__setattr__(self, "parts", tuple(parts))


@dataclass(frozen=True)
class Alt(_Node):
    options: tuple

    def __init__(self, *options):
        object.__setattr__(self, "options", tuple(options))


@dataclass(frozen=True)
class Rep(_Node):
    """``lo`` to ``hi`` repetitions of ``r``; ``hi=None`` is unbounded."""

    r: _Node
    lo: int
    hi: Optional[int]


def Opt(r: _Node) -> _Node:
    return Rep(r, 0, 1)


def Star(r: _Node) -> _Node:
    return Rep(r, 0, None)


def Plus(r: _Node) -> _Node:
    return Rep(r, 1, None)


class _Nfa:
    """states: eps edges + char-class edges; single accept per build."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[str, bool, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def add(self, node: _Node) -> tuple[int, int]:
        if isinstance(node, Lit):
            s0 = self.state()
            cur = s0
            for ch in node.s:
                nxt = self.state()
                self.edges[cur].append((ch, False, nxt))
                cur = nxt
            return s0, cur
        if isinstance(node, Cls):
            s0, s1 = self.state(), self.state()
            self.edges[s0].append((node.chars, node.negate, s1))
            return s0, s1
        if isinstance(node, Seq):
            s0 = self.state()
            cur = s0
            for p in node.parts:
                a, b = self.add(p)
                self.eps[cur].append(a)
                cur = b
            return s0, cur
        if isinstance(node, Alt):
            s0, s1 = self.state(), self.state()
            for opt in node.options:
                a, b = self.add(opt)
                self.eps[s0].append(a)
                self.eps[b].append(s1)
            return s0, s1
        if isinstance(node, Rep):
            s0 = self.state()
            cur = s0
            for _ in range(node.lo):
                a, b = self.add(node.r)
                self.eps[cur].append(a)
                cur = b
            if node.hi is None:  # star tail
                a, b = self.add(node.r)
                self.eps[cur].append(a)
                self.eps[b].append(cur)
                return s0, cur
            end = self.state()
            self.eps[cur].append(end)
            for _ in range(node.hi - node.lo):
                a, b = self.add(node.r)
                self.eps[cur].append(a)
                cur = b
                self.eps[cur].append(end)
            return s0, end
        raise TypeError(node)


_OTHER = "\x00"  # stands for "any char outside the explicit alphabet"


class CharDfa:
    """Subset-construction DFA. ``trans``: list of {symbol: state};
    symbols are explicit chars plus ``_OTHER``; missing symbol = dead."""

    def __init__(self, node: _Node):
        nfa = _Nfa()
        start, accept = nfa.add(node)

        alphabet = sorted({
            c for es in nfa.edges for chars, _, _ in es for c in chars
        })
        aset = set(alphabet)

        def closure(states: frozenset) -> frozenset:
            stack, seen = list(states), set(states)
            while stack:
                s = stack.pop()
                for t in nfa.eps[s]:
                    if t not in seen:
                        seen.add(t)
                        stack.append(t)
            return frozenset(seen)

        def move(states: frozenset, sym: str) -> frozenset:
            out = set()
            for s in states:
                for chars, neg, dst in nfa.edges[s]:
                    if sym == _OTHER:
                        hit = neg  # OTHER chars are outside every pos class
                    else:
                        hit = (sym not in chars) if neg else (sym in chars)
                    if hit:
                        out.add(dst)
            return frozenset(out)

        init = closure(frozenset([start]))
        index = {init: 0}
        order = [init]
        trans: list[dict[str, int]] = [{}]
        todo = [init]
        while todo:
            cur = todo.pop()
            i = index[cur]
            for sym in alphabet + [_OTHER]:
                nxt = closure(move(cur, sym))
                if not nxt:
                    continue
                if nxt not in index:
                    index[nxt] = len(order)
                    order.append(nxt)
                    trans.append({})
                    todo.append(nxt)
                trans[i][sym] = index[nxt]

        self.trans = trans
        self.accept = [accept in st for st in order]
        self.alphabet = aset

    def walk(self, state: int, text: str) -> int:
        """Advance through ``text``; -1 = dead."""
        for ch in text:
            sym = ch if ch in self.alphabet else _OTHER
            state = self.trans[state].get(sym, -1)
            if state < 0:
                return -1
        return state

    def matches(self, text: str) -> bool:
        s = self.walk(0, text)
        return s >= 0 and self.accept[s]


# ---------------------------------------------------------------------------
# Token-level lifting
# ---------------------------------------------------------------------------


@dataclass
class TokenFsm:
    """``next_state [S, V] int32`` (-1 = token forbidden in that state);
    EOS column self-loops in accepting states. Device placement happens at
    the consumer (Generator pads V to the lane-padded logits width)."""

    next_state: np.ndarray
    eos_id: int
    n_states: int


def compile_grammar(node: _Node, tokenizer,
                    allow_leading_space: bool = True) -> TokenFsm:
    """Compile an answer grammar against a tokenizer. BPE pieces carry a
    leading space marker on word starts ('▁There' -> ' There'), so the
    grammar gets an optional leading-space prefix by default."""
    if allow_leading_space:
        node = Seq(Opt(Lit(" ")), node)
    dfa = CharDfa(node)
    S = len(dfa.trans)
    V = tokenizer.n_words
    # dense char-transition matrix [S+1, A] with a dead row at index S so
    # the per-token lift vectorizes over all start states at once
    # (python walks would be S*V*|piece| ~ 50M steps at 32k vocab)
    syms = sorted(dfa.alphabet) + [_OTHER]
    sym_idx = {c: i for i, c in enumerate(syms)}
    dense = np.full((S + 1, len(syms)), S, np.int32)
    for s, tr in enumerate(dfa.trans):
        for c, d in tr.items():
            dense[s, sym_idx[c]] = d
    nxt = np.full((S, V), -1, np.int32)
    all_states = np.arange(S)
    for t in range(V):
        piece = tokenizer.id_to_piece(t)
        if not piece:
            continue  # specials / empty pieces never legal mid-answer
        cur = all_states
        for ch in piece:
            cur = dense[cur, sym_idx.get(ch, len(syms) - 1)]
        nxt[:, t] = np.where(cur == S, -1, cur)
    eos = tokenizer.eos_id
    for s in range(S):
        nxt[s, eos] = s if dfa.accept[s] else -1
    # liveness: a reachable non-accepting state with no legal token would
    # wedge decoding (argmax over all -inf) — fail at compile time instead
    dead = [
        s for s in range(S)
        if not dfa.accept[s] and not (nxt[s] >= 0).any()
    ]
    if dead:
        raise ValueError(
            f"grammar has {len(dead)} token-dead states under this "
            f"tokenizer (e.g. state {dead[0]}): some required character "
            "sequence is not spellable with its vocabulary"
        )
    return TokenFsm(next_state=nxt, eos_id=eos, n_states=S)


# ---------------------------------------------------------------------------
# A3VLM answer grammars (byte formats of codecs/triad.py)
# ---------------------------------------------------------------------------


def _num2() -> _Node:
    """"{:.2f}"-formatted float: optional sign, 1-3 integer digits, two
    decimals (vqa_task_construction.py:121-151 boxes are 2-decimal)."""
    return Seq(
        Opt(Lit("-")), Rep(Cls(_DIGITS), 1, 3), Lit("."),
        Rep(Cls(_DIGITS), 2, 2),
    )


def _num_list(n: int) -> _Node:
    return Seq(
        Lit("["), _num2(), Rep(Seq(Lit(","), _num2()), n - 1, n - 1),
        Lit("]"),
    )


def rotated_box_grammar(with_depth: bool = False) -> _Node:
    """"[cx,cy,w,h,angle]" (6 values with depth) — format_rotated_box."""
    return _num_list(6 if with_depth else 5)


JOINT_TYPES = ("revolute", "prismatic", "fixed", "continuous")


def joint_rec_grammar(with_depth: bool = False) -> _Node:
    """"<rb>{type}</rb>[box]" — format_joint_answer over a rotated box."""
    return Seq(
        Lit("<rb>"), Alt(*[Lit(t) for t in JOINT_TYPES]), Lit("</rb>"),
        rotated_box_grammar(with_depth),
    )


def _link_name() -> _Node:
    return Rep(Cls("<>,.", negate=True), 1, 48)


def det_all_grammar(
    item: Optional[_Node] = None,
    start_delim: str = "<rb>",
    end_delim: str = "</rb>",
    noun: str = "rotated bounding box",
    noun_plural: str = "rotated bounding boxes",
    max_det: int = 10,
) -> _Node:
    """The det-all sentence of codecs/triad._det_all_answer: count word,
    then "<rb>{link}</rb>[box]" items ','-separated, '.'-terminated.
    Count/item-number agreement is NOT encoded (it would multiply DFA
    states ~10x for a property the scorer checks anyway)."""
    from a3vlm_tpu_torch.codecs import vocab as V

    if item is None:
        item = rotated_box_grammar()
    one_item = Seq(Lit(start_delim), _link_name(), Lit(end_delim), item)
    words = [V.NUMBER_WORDS[i] for i in range(2, max_det + 1)]
    head = Alt(
        Seq(Lit("There is one manipulable object part with its "),
            Lit(noun), Lit(": ")),
        Seq(Lit("There are "), Alt(*[Lit(w) for w in words]),
            Lit(" manipulable object parts with their "),
            Lit(noun_plural), Lit(": ")),
    )
    return Seq(
        head, Rep(Seq(one_item, Lit(",")), 0, max_det - 1), one_item,
        Lit("."),
    )


def bbox_3d_grammar(use_eight_points: bool = False) -> _Node:
    """9-dof "[c,e,rotvec]" (9 values) or 8-corner "[[x,y,z]x8]" —
    format_bbox_3d (vqa_task_construction.py:441-491)."""
    if not use_eight_points:
        return _num_list(9)
    corner = _num_list(3)
    return Seq(Lit("["), corner, Rep(Seq(Lit(","), corner), 7, 7), Lit("]"))


def axis_3d_grammar() -> _Node:
    """"<axis>{type}</axis>[[x,y,z],[x,y,z]]" — format_axis_answer over
    format_axis_3d's two endpoints."""
    seg = Seq(Lit("["), _num_list(3), Lit(","), _num_list(3), Lit("]"))
    return Seq(
        Lit("<axis>"), Alt(*[Lit(t) for t in JOINT_TYPES]), Lit("</axis>"),
        seg,
    )


# task-stream filename fragment -> grammar constructor (eval opt-in routing)
GRAMMARS = {
    "single_link_rec": lambda: joint_rec_grammar(),
    "joint_rec": lambda: joint_rec_grammar(),
    "det_all": lambda: det_all_grammar(),
    "bbox_3d": lambda: bbox_3d_grammar(),
    "axis_3d": lambda: axis_3d_grammar(),
}


_FSM_CACHE: dict = {}


def fsm_for_task(task_name: str, tokenizer) -> Optional[TokenFsm]:
    """Pick (and cache) the grammar FSM for an eval task file name;
    None when no grammar family matches (free-text streams stay
    unconstrained)."""
    for frag, build in GRAMMARS.items():
        if frag in task_name:
            key = (frag, id(tokenizer))
            if key not in _FSM_CACHE:
                _FSM_CACHE[key] = compile_grammar(build(), tokenizer)
            return _FSM_CACHE[key]
    return None
