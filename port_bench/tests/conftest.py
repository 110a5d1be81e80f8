"""Shared set-up of the benchmark's tests: the checkout on the import path,
the ``cuda`` marker, and a tiny copy of the benchmark (two tiny
configurations, one of each family, and a cell on each) that the harness
runs on the CPU.

    python -m pytest port_bench/tests -q            # CPU; cuda tests skip
    python -m pytest port_bench/tests -q -m cuda    # on a card"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_7B = {
    "family": "internlm2_ens5", "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 192, "vocab_size": 256, "rope_theta": 1000000,
    "rms_norm_eps": 1e-5, "max_seq_len": 512, "dtype": "bfloat16",
    "quant": {"bits": 4, "group_size": 64},
    "towers": {
        "image_size": 128, "dino_crop": 14, "convnext_crop": 64,
        "dinov2": {"width": 40, "layers": 2, "heads": 4, "mlp_dim": 64,
                   "patch_size": 7, "pos_grid_size": 4, "norm_eps": 1e-6},
        "convnext": {"depths": [1, 1, 1, 1], "dims": [8, 16, 32, 64],
                     "norm_eps": 1e-6},
        "proj_norm_eps": 1e-5,
        "input_mean": [0.48145466, 0.4578275, 0.40821073],
        "input_std": [0.26862954, 0.26130258, 0.27577711],
        "dinov2_mean": [0.485, 0.456, 0.406],
        "dinov2_std": [0.229, 0.224, 0.225]}}
TINY_FALCON = {
    "family": "falcon", "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_kv_heads": 2, "vocab_size": 256,
    "layer_norm_epsilon": 1e-5, "new_decoder_architecture": True,
    "parallel_attn": True, "bias": False, "rope_theta": 10000.0,
    "max_position_embeddings": 256, "dtype": "bfloat16",
    "quant": {"bits": 4, "group_size": 64}}
TINY_MIXES = {
    "tiny-eval": {"batch": 4, "prompt_len": [[8, 9, 0.5], [11, 12, 0.5]], "new_ids": 8, "bos": 1,
                  "shared_prefix": 2, "first_id": 3,
                  "images": {"size": 128, "questions_per_render": 3}},
    "tiny-chat": {"batch": 4, "prompt_len": [[9, 17, 1.0]], "new_ids": 6,
                  "bos": None, "shared_prefix": 3, "first_id": 12,
                  "images": None},
}
# set from readings on the CPU: sound runs over 12 seeds read a mean
# excess of at most 0.0134 (tiny-7b) and 0 (tiny-falcon); the mildest
# fault, a cache never written, 0.0275 and 0.118
TINY_LIMITS = {"mean_excess": 0.02}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def make_tiny_root(root: Path) -> Path:
    """A checkout-shaped directory: BENCHMARK.json with the tiny cells
    ``tiny-7b`` and ``tiny-falcon``, and the files they name; the metric
    readers are the benchmark's own."""
    pb = root / "port_bench"
    shutil.copytree(ROOT / "port_bench" / "metrics", pb / "metrics")
    write_json(pb / "configs" / "tiny-7b.json", TINY_7B)
    write_json(pb / "configs" / "tiny-falcon.json", TINY_FALCON)
    for name, mix in TINY_MIXES.items():
        write_json(pb / "traffic" / f"{name}.json", mix)
    for cell in ("tiny-7b", "tiny-falcon"):
        write_json(pb / "workloads" / f"{cell}.json",
                   {"check": {"sample": 3, "limits": TINY_LIMITS}})
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"] = [
        {"name": n, "source": "tests", "file": f"port_bench/configs/{n}.json",
         "reduced": [], "why": "tests"} for n in ("tiny-7b", "tiny-falcon")]
    bench["workloads"] = [
        {"name": "tiny-7b", "config": "tiny-7b", "traffic": "tiny-eval",
         "chips": 1, "why": "tests"},
        {"name": "tiny-falcon", "config": "tiny-falcon",
         "traffic": "tiny-chat", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" not in m:
            continue
        m["workloads"] = (["tiny-7b"] if m["name"] == "towers_ms_per_image"
                          else ["tiny-7b", "tiny-falcon"])
    write_json(root / "BENCHMARK.json", bench)
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path / "checkout")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
