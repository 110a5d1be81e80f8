"""Per-object render driver (reference data_gen/render_robot_pyrender.py):
URDF -> FK -> two render passes (link-level for masks/depth, visual-level
for color) -> raw/depth/real_depth/mask PNGs + info.json + annotations.json
+ combined y/z-swapped mesh_i.obj export.

No multiprocessing pool (this host has one core; callers parallelize per
object externally if wanted)."""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from a3vlm_tpu_torch.datagen import mesh as M
from a3vlm_tpu_torch.datagen import urdf as U
from a3vlm_tpu_torch.datagen.render import render_parts

DEFAULT_CAMERA_INFO = {
    # render_robot_pyrender.py:231-240 defaults
    "fx": 1000.0, "fy": 1000.0, "cx": 480.0, "cy": 480.0,
    "width": 960, "height": 960,
}


def render_data_item(
    data_name: str,
    data_dir: str,
    output_dir: str,
    num_poses: int = 5,
    camera_info: Optional[dict] = None,
    cam_radius_max: float = 4.0,
    cam_radius_min: float = 3.0,
    num_joint_value: int = 8,
    only_front: bool = False,
    seed: int = 0,
) -> bool:
    camera_info = camera_info or DEFAULT_CAMERA_INFO
    rng = np.random.default_rng(seed)
    data_path = f"{data_dir}/{data_name}"
    out = f"{output_dir}/{data_name}"
    image_dir = os.path.join(out, "raw_images")
    depth_dir = os.path.join(out, "depth_images")
    real_depth_dir = os.path.join(out, "real_depth_images")
    mask_dir = os.path.join(out, "mask")
    for d in (out, image_dir, depth_dir, real_depth_dir, mask_dir):
        os.makedirs(d, exist_ok=True)

    info: dict = {"camera_info": camera_info}
    meta_file = f"{data_path}/meta.json"
    if os.path.isfile(meta_file):
        with open(meta_file) as f:
            info["model_cat"] = json.load(f).get("model_cat", "Unknown")
    annotations = []

    import cv2

    try:
        for i in range(num_joint_value):
            robot = U.URDF.load(f"{data_path}/mobility.urdf")
            kinematic_level = U.compute_kinematic_level(robot)

            # joint sampling (render_robot_pyrender.py:88-110: fixed 0.5,
            # hierarchical objects zeroed)
            joint_cfg: dict = {}
            link_cfg: dict = {}
            for joint in robot.actuated_joints:
                joint_value_sample = 0.5
                if joint.limit is not None:
                    lo, hi = joint.limit.lower, joint.limit.upper
                    joint_value = joint_value_sample * (hi - lo) + lo
                    if kinematic_level > 1:
                        joint_value = 0.0
                    joint_cfg[joint.name] = joint_value
                    link_cfg[joint.child] = (joint_value - lo) / (
                        hi - lo + 1e-6
                    )

            link_poses = robot.link_fk(cfg=joint_cfg)
            link_mesh_map = {}
            visual_mesh_map = {}
            for link in robot.links:
                pose = link_poses[link.name]
                cm = M.load_link_mesh(link.collisions)
                if cm is not None:
                    link_mesh_map[link.name] = (cm, pose)
                vm = M.load_link_mesh(link.visuals)
                if vm is not None:
                    visual_mesh_map[f"{link.name}_visual"] = (vm, pose)

            _annotations, camera_poses, _, depth_imgs, mask_imgs = (
                render_parts(
                    link_mesh_map,
                    num_poses,
                    camera_info,
                    cam_radius_max,
                    cam_radius_min,
                    image_idx_offset=i * num_poses,
                    only_front=only_front,
                    camera_sample_method="xy",
                    rng=rng,
                )
            )
            _, _, color_imgs, _, _ = render_parts(
                visual_mesh_map,
                num_poses,
                camera_info,
                cam_radius_max,
                cam_radius_min,
                image_idx_offset=0,
                only_front=only_front,
                camera_sample_method="xy",
                predefine_camera_poses=camera_poses,
                is_link_map=False,
                rng=rng,
            )

            # combined world mesh, y/z swapped, exported per joint config
            world = [
                m.copy().apply_transform(pose)
                for m, pose in link_mesh_map.values()
            ]
            robot_mesh = M.concatenate(world).apply_transform(M.YZ_SWAP)
            robot_mesh.export_obj(f"{out}/mesh_{i}.obj")

            for link_name, v in link_cfg.items():
                info.setdefault(link_name, [])
                info[link_name] += [v] * num_poses
            info.setdefault("camera_poses", [])
            info["camera_poses"] += camera_poses
            annotations += _annotations

            for j, img in enumerate(color_imgs):
                cv2.imwrite(
                    f"{image_dir}/{i * num_poses + j:06d}.png",
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                )
            for j, depth_img in enumerate(depth_imgs):
                zero = depth_img == 0
                if (~zero).any():
                    dmin, dmax = depth_img[~zero].min(), depth_img[~zero].max()
                else:
                    dmin, dmax = 0.0, 1.0
                norm = (depth_img - dmin) / (dmax - dmin + 1e-6)
                norm[zero] = 0
                norm[~zero] = 0.9 * (1 - norm[~zero]) + 0.1
                cv2.imwrite(
                    f"{depth_dir}/{i * num_poses + j:06d}.png",
                    (norm * 255).astype(np.uint8),
                )
                cv2.imwrite(
                    f"{real_depth_dir}/{i * num_poses + j:06d}.png",
                    (depth_img * 1000).astype(np.uint16),
                )
            for j, img in enumerate(mask_imgs):
                cv2.imwrite(f"{mask_dir}/{i * num_poses + j:06d}.png", img)
    except Exception as e:
        print(f"Error in {data_name}: {e}")
        return False

    with open(f"{out}/info.json", "w") as f:
        json.dump(info, f)
    with open(f"{out}/annotations.json", "w") as f:
        json.dump(annotations, f)
    for fn in ("semantics.txt", "mobility.urdf", "meta.json",
               "mobility_v2.json"):
        src = f"{data_path}/{fn}"
        if os.path.isfile(src):
            shutil.copy(src, f"{out}/{fn}")
    return True


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("render PartNet-Mobility objects")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_name", default="all")
    p.add_argument("--num_poses", type=int, default=5)
    p.add_argument("--num_joint_value", type=int, default=8)
    p.add_argument("--only_front", action="store_true")
    args = p.parse_args(argv)

    if args.data_name != "all":
        names = [args.data_name]
    else:
        names = sorted(
            d for d in os.listdir(args.data_dir) if d.isdigit()
        )
    ok = 0
    for name in names:
        if render_data_item(
            name, args.data_dir, args.output_dir,
            num_poses=args.num_poses,
            num_joint_value=args.num_joint_value,
            only_front=args.only_front,
        ):
            ok += 1
    print(f"rendered {ok}/{len(names)} objects")


if __name__ == "__main__":
    main()
