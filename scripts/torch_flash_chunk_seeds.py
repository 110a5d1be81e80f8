"""K2 at the chunked-prefill shape over many random samples, on one CUDA card.

    python3 scripts/torch_flash_chunk_seeds.py [--seeds 64] [--sq 476] [--skv 1500]

Draws q, k and v [1, 40, S, 128] bf16 from each seed (a CUDA generator,
as ``chip_smoke.py`` draws them) and holds the port's flash forward (K2,
causal, right-aligned) against its plain version under two bounds:

- the plain bound of ``chip_smoke.py``'s phase 3 and the card tests'
  ``_check``: 2^-6 |plain| + 1e-3 max|plain|;
- that bound plus what rounding the softmax weights to bf16 before the
  value product (as the TPU kernel holds them) could cost: each weight
  moves by at most 2^-8 of itself, in the product and in the row sum, so an
  output moves by at most 2^-7 sum_i p_i |v_i|, which is the plain
  attention over |v|. The kernel carries the weights as a high and a low
  bf16 part, so it should keep well inside the first bound.

Prints, for each seed, how many elements leave each bound, the largest
error and its ratio to each bound, and where the first element outside the
plain bound lies (head, row, column, the plain value, the keys the row
sees). The last line is one JSON object of these numbers. Exits 1 if any
seed leaves the plain bound.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=64)
    parser.add_argument("--sq", type=int, default=476)
    parser.add_argument("--skv", type=int, default=1500)
    opts = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke as cs
    from a3vlm_tpu_torch.ops.flash_attention import (
        flash_attention_bhsd, flash_attention_bhsd_plain)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the card")
    card = cs.device_line()
    print(card)
    H, D, Sq, Skv = 40, 128, opts.sq, opts.skv
    seen = Skv - Sq + 1 + torch.arange(Sq, device="cuda")  # keys a row sees
    rows = []
    with torch.inference_mode():
        for seed in range(opts.seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v = (cs.randn(1, H, S, D, gen=gen) for S in (Sq, Skv, Skv))
            got = flash_attention_bhsd(q, k, v, causal=True).float()
            want = flash_attention_bhsd_plain(q, k, v, causal=True).float()
            spread = flash_attention_bhsd_plain(
                q.float(), k.float(), v.float().abs(), causal=True)
            err = (got - want).abs()
            plain = cs.RTOL * want.abs() + cs.ATOL_FRAC * want.abs().max()
            model = plain + 2.0 ** -7 * spread
            out_plain, out_model = err > plain, err > model
            row = {"seed": seed, "outside_plain": int(out_plain.sum()),
                   "outside_model": int(out_model.sum()),
                   "max_err": float(err.max()),
                   "max_err_over_plain": float((err / plain).max()),
                   "max_err_over_model": float((err / model).max())}
            line = (f"[{card}] seed {seed:2d}: {row['outside_plain']} "
                    f"outside the plain bound, {row['outside_model']} "
                    f"outside the modelled one; max err {row['max_err']:.5g}"
                    f", max err / plain bound "
                    f"{row['max_err_over_plain']:.4f}, / modelled bound "
                    f"{row['max_err_over_model']:.4f}")
            if row["outside_plain"]:
                i = int(out_plain.flatten().nonzero()[0])
                h, r, c = i // (Sq * D), i // D % Sq, i % D
                row["first"] = {
                    "head": h, "row": r, "col": c,
                    "plain": float(want.flatten()[i]),
                    "kernel": float(got.flatten()[i]),
                    "spread": float(spread.flatten()[i]),
                    "keys_seen": int(seen[r])}
                line += f"; first outside {row['first']}"
            print(line)
            rows.append(row)
    failing = [r["seed"] for r in rows if r["outside_plain"]]
    print(f"[{card}] {len(failing)} of {opts.seeds} seeds leave the plain "
          f"bound: {failing}; "
          f"{sum(1 for r in rows if r['outside_model'])} leave the modelled "
          f"one")
    print(json.dumps({"device": card, "shape": [1, H, Sq, Skv, D],
                      "seeds_outside_plain": failing, "rows": rows}))
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
