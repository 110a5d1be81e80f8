"""What sets the time of the port's int4 GEMV (K1, K1v3): bytes or arithmetic.

    python3 scripts/torch_gemv_variants.py [--ms 1,4,32] [--reps 20]

Builds ``a3vlm_tpu_torch/csrc/int4_matmul.cu`` three times into the
git-ignored build directory (in parallel): as the library builds it, and
over two patched copies of the GEMV's header (``gemv_cluster.cuh``, which
the copy of int4_matmul.cu beside it includes): copy-only (the producer
streams every stage into the ring, the consumers wait for each and compute
nothing) and math-only (no copies; the consumers compute on whatever the
ring holds). The patches are exact text replacements in the GEMV's
consumer loop and producer warp; the script stops where the source no
longer holds them. At
each decoder linear (K padded, N) and each M, it times the three on the
device (``torch.profiler``, a rotation of weight copies larger than the L2,
as ``chip_smoke.py`` times the GEMV rows) in the order full, copy, math,
full, for v1 and v3, and prints them beside the byte bound (the weight and
its scales over 3.35 TB/s). Where the full kernel takes about as long as the
copy-only one, the bytes set its time; where it takes about as long as the
math-only one, the instructions do. The last line is one JSON object of the
numbers. Random weights from a seed; one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the consumers' wait for a stage, and the producer warp's copies
_WAIT = "    mbar_wait(smem_u32(&full[my_slot]), my_round & 1);\n"
_PRODUCE = "    if (producer) {\n"
_SKIP_MATH = ("      __syncwarp();\n"
              "      if (lane == 0) mbar_arrive(smem_u32(&empty[my_slot]));\n"
              "      continue;\n")
# variant -> (text, replacement) pairs
VARIANTS = {
    "full": [],
    "copy": [(_WAIT, _WAIT + "    {\n" + _SKIP_MATH + "    }\n")],
    "math": [(_WAIT, ""), (_PRODUCE, "    if (producer && false) {\n")],
}


def patched(csrc: Path, name: str, out_dir: Path) -> Path:
    """A copy of int4_matmul.cu in a directory of its own beside the GEMV's
    header with variant ``name``'s replacements, each of whose text the
    header must hold exactly once (a quoted include finds the copy's
    neighbour first)."""
    header = csrc / "gemv_cluster.cuh"
    text = header.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{header.name} no longer holds the text the "
                               f"{name} variant replaces: {old!r}")
        text = text.replace(old, new)
    where = out_dir / name
    where.mkdir(parents=True, exist_ok=True)
    (where / header.name).write_text(text)
    path = where / "int4_matmul.cu"
    path.write_text((csrc / "int4_matmul.cu").read_text())
    return path


def build(out_dir: Path) -> dict:
    """One shared library of int4_matmul.cu per variant; {name: CDLL}."""
    from a3vlm_tpu_torch.ops import _kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    procs = {}
    for name in VARIANTS:
        so = out_dir / f"gemv_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC_DIR),
             "-shared", str(patched(_kernels.CSRC_DIR, name, out_dir)), "-o",
             str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{out}")
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.a3_int4_gemv.argtypes = [I] + [P] * 6 + [I] * 6 + [P]
        lib.a3_int4_gemv_clusters.argtypes = [I, I, I, I]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ms", default="1,4,32")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke as cs
    from a3vlm_tpu_torch.ops import _kernels
    from a3vlm_tpu_torch.ops import quant_matmul as qmm
    from a3vlm_tpu_torch.quant import _quantize_leaf_int4

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the card")
    card = cs.device_line()
    print(card)
    t0 = time.perf_counter()
    libs = build(_kernels.BUILD_DIR / "gemv_variants")
    print(f"[{card}] variants built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(opts.seed)
    rows = []
    with torch.inference_mode():
        for K, N in cs.LINEAR_SHAPES:
            qw = _quantize_leaf_int4(cs.random_weight(K, N, gen))
            half = qw.q.shape[0]
            copies = cs.weight_copies(qw)
            bound = (qw.q.numel() + 4 * qw.scale.numel()) / 3.35e12 * 1e3
            for M in (int(m) for m in opts.ms.split(",")):
                x = cs.randn(M, 2 * half, gen=gen)
                out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
                for mode in ("v1", "v3"):
                    times = {}
                    for name in ("full", "copy", "math", "full"):
                        lib = libs[name]
                        cap = [lib.a3_int4_gemv_clusters(
                            qmm._GEMV_MODES[mode], M, qw.group, c)
                            for c in range(1, qmm.GEMV_MAX_CLUSTER + 1)]
                        C = qmm.gemv_splits(N, half, qw.group, cap)

                        def call(q, s, lib=lib, C=C, mode=mode):
                            err = lib.a3_int4_gemv(
                                qmm._GEMV_MODES[mode], x.data_ptr(), None,
                                q.data_ptr(), s.data_ptr(), None,
                                out.data_ptr(), M, half, N, qw.group, half,
                                C, _kernels.stream())
                            if err:
                                raise RuntimeError(f"a3_int4_gemv: {err}")

                        ms = cs.device_ms(cs.rotation(call, copies),
                                          reps=opts.reps)
                        times.setdefault(name, []).append(ms)
                    row = {"K": 2 * half, "N": N, "M": M, "mode": mode,
                           "C": C, "bound_ms": bound,
                           **{k: v for k, v in times.items()}}
                    rows.append(row)
                    full = " / ".join(f"{t:.4f}" for t in times["full"])
                    print(f"[{card}] {mode} M={M:2d} K={2 * half} N={N} "
                          f"C={C}: full {full} ms, copy only "
                          f"{times['copy'][0]:.4f}, math only "
                          f"{times['math'][0]:.4f}, bound {bound:.4f} ms")
            del copies
    print(json.dumps({"device": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
