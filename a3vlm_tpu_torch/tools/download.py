"""Checkpoint downloader (reference model/accessory/tools/download.py): an
interactive HF snapshot fetcher for the model zoo. Network-gated — in
zero-egress environments point --local_path at pre-staged weights."""

from __future__ import annotations

import argparse

MODEL_ZOO = [
    # the upstream zoo the reference lists (LLM/__init__.py:1-14)
    "llama", "llama_peft", "llama_qformerv2", "llama_ens", "llama_ens5",
    "llama_ens5_2images", "internlm_ems5_light", "falcon", "mixtral",
]


def download(repo_id: str, local_dir: str) -> str:
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:  # pragma: no cover
        raise ImportError("huggingface_hub unavailable") from e
    return snapshot_download(repo_id=repo_id, local_dir=local_dir)


def main(argv=None):  # pragma: no cover - network
    p = argparse.ArgumentParser("download released checkpoints")
    p.add_argument("--repo_id", required=True)
    p.add_argument("--local_dir", required=True)
    args = p.parse_args(argv)
    print(download(args.repo_id, args.local_dir))


if __name__ == "__main__":
    main()
