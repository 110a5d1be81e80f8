"""Texture-domain augmentation stage (reference data_gen/controlnet_render.py
+ controlnet_tools.py):

- ``construct_dataset_index``: builds the render CSV joining depth/mask
  renders with per-category texture prompts (controlnet_tools.py:165-294).
- ``colorize_seg_ade``: ADE-20k-palette colorized segmentation conditioning
  images (controlnet_tools.py:7-161's palette use).
- ``run_controlnet``: the SD 1.5 + ControlNet generation loop — requires the
  optional ``diffusers`` package and an accelerator; cleanly gated so the
  rest of the pipeline is usable without it (this stage is an offline
  augmentation, not a training dependency).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional

import numpy as np

# first 32 rows of the ADE-20k palette (enough to color PartNet link ids;
# cycled beyond that)
ADE_PALETTE = [
    (120, 120, 120), (180, 120, 120), (6, 230, 230), (80, 50, 50),
    (4, 200, 3), (120, 120, 80), (140, 140, 140), (204, 5, 255),
    (230, 230, 230), (4, 250, 7), (224, 5, 255), (235, 255, 7),
    (150, 5, 61), (120, 120, 70), (8, 255, 51), (255, 6, 82),
    (143, 255, 140), (204, 255, 4), (255, 51, 7), (204, 70, 3),
    (0, 102, 200), (61, 230, 250), (255, 6, 51), (11, 102, 255),
    (255, 7, 71), (255, 9, 224), (9, 7, 230), (220, 220, 220),
    (255, 9, 92), (112, 9, 255), (8, 255, 214), (7, 255, 224),
]


def colorize_seg_ade(mask: np.ndarray) -> np.ndarray:
    """link-id mask -> RGB conditioning image with the ADE palette."""
    out = np.zeros((*mask.shape, 3), np.uint8)
    for mid in np.unique(mask):
        if mid == 0:
            continue
        out[mask == mid] = ADE_PALETTE[int(mid) % len(ADE_PALETTE)]
    return out


_MATERIALS = [
    "wooden", "brushed metal", "white plastic", "matte black",
    "stainless steel", "painted red", "glossy ceramic", "worn vintage",
]
_CONTEXTS = [
    "in a bright kitchen", "in a modern living room", "in a workshop",
    "studio product photo", "in an office", "on a wooden floor",
]


def generate_texture_prompts(category: str, n: int = 8, seed: int = 0):
    """Offline texture-prompt generation — the zero-egress replacement for
    the GPT-4 prompt generator (openai_description.py:20-106). Produces the
    same {category: [prompt, ...]} bank format construct_dataset_index
    consumes; the API-backed path can be swapped in where network exists."""
    import random as _random

    rng = _random.Random(seed + hash(category) % 10_000)
    prompts = []
    seen = set()
    while len(prompts) < n:
        p = (
            f"a {rng.choice(_MATERIALS)} {category.lower()} "
            f"{rng.choice(_CONTEXTS)}, photorealistic, detailed texture"
        )
        if p not in seen:  # dedup vs history (openai_description.py:95-100)
            seen.add(p)
            prompts.append(p)
    return prompts


def generate_prompt_bank(categories, out_json: str, n: int = 8) -> str:
    import json as _json

    bank = {c: generate_texture_prompts(c, n) for c in categories}
    with open(out_json, "w") as f:
        _json.dump(bank, f, indent=2)
    return out_json


def construct_dataset_index(
    render_dir: str,
    prompts_json: str,
    csv_path: str,
    control: str = "depth",
) -> int:
    """Join renders with per-category texture prompts into the generation
    CSV (controlnet_tools.py:165-294). ``prompts_json``:
    {category: [prompt, ...]} (the openai_description.py output format)."""
    with open(prompts_json) as f:
        prompts = json.load(f)
    rows = []
    rng = np.random.default_rng(0)
    for obj in sorted(os.listdir(render_dir)):
        obj_dir = os.path.join(render_dir, obj)
        meta_file = os.path.join(obj_dir, "meta.json")
        if not os.path.isfile(meta_file):
            continue
        with open(meta_file) as f:
            cat = json.load(f).get("model_cat", "Unknown")
        cat_prompts = prompts.get(cat, [])
        if not cat_prompts:
            continue
        depth_dir = os.path.join(obj_dir, "depth_images")
        mask_dir = os.path.join(obj_dir, "mask")
        if not os.path.isdir(depth_dir):
            continue
        for fn in sorted(os.listdir(depth_dir)):
            rows.append(
                {
                    "object": obj,
                    "category": cat,
                    "depth": os.path.join(depth_dir, fn),
                    "mask": os.path.join(mask_dir, fn),
                    "prompt": cat_prompts[rng.integers(len(cat_prompts))],
                }
            )
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["object", "category", "depth", "mask", "prompt"]
        )
        writer.writeheader()
        writer.writerows(rows)
    return len(rows)


def run_controlnet(
    csv_path: str,
    output_root: str,
    control: str = "depth",
    images_per_prompt: int = 4,
    model_id: str = "runwayml/stable-diffusion-v1-5",
    controlnet_id: Optional[str] = None,
    pipe=None,
):
    """SD + ControlNet generation (controlnet_render.py:122-194).

    ``pipe``: injectable pipeline — anything callable as
    ``pipe(prompt, image=..., num_images_per_prompt=N)`` returning an
    object with an ``.images`` list of PIL images (the diffusers
    StableDiffusionControlNetPipeline interface). When None, the real
    diffusers pipeline is built (optional dependency; the generation loop
    itself is covered by tests with a stub pipeline)."""
    if pipe is None:  # pragma: no cover - requires diffusers + accelerator
        try:
            from diffusers import (
                ControlNetModel,
                StableDiffusionControlNetPipeline,
            )
        except ImportError as e:
            raise ImportError(
                "texture augmentation requires the optional `diffusers` "
                "package and an accelerator; install it or skip this "
                "offline stage"
            ) from e

        controlnet_id = controlnet_id or (
            "lllyasviel/control_v11f1p_sd15_depth"
            if control == "depth"
            else "lllyasviel/control_v11p_sd15_seg"
        )
        controlnet = ControlNetModel.from_pretrained(controlnet_id)
        pipe = StableDiffusionControlNetPipeline.from_pretrained(
            model_id, controlnet=controlnet
        )
    from PIL import Image

    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        cond = Image.open(row["depth" if control == "depth" else "mask"])
        out_dir = os.path.join(
            output_root, row["object"],
            "controlnet_images" if control == "depth"
            else "controlnet_images_seg",
        )
        os.makedirs(out_dir, exist_ok=True)
        images = pipe(
            row["prompt"], image=cond,
            num_images_per_prompt=images_per_prompt,
        ).images
        stem = os.path.splitext(os.path.basename(row["depth"]))[0]
        for i, img in enumerate(images):
            img.save(os.path.join(out_dir, f"{int(stem)}_{i}.png"))
