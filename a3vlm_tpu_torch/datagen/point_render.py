"""Depth -> point cloud + 3D triad annotation (reference
data_gen/point_render.py). Produces per-image ``annotations_3d.json`` with,
for every movable joint: the joint frame (``joint_T``), the 9-dof oriented
box fitted **in the joint frame** (``bbox_3d``), and the axis interaction
points (``itp_points``).

All geometry conventions match the reference to the digit (SURVEY.md §7 hard
part #6): y-up -> z-up conversion of axis origin/direction (:528-530), the
joint frame construction (:532-543), the minimum-projected OBB with the
near-circle fallback (via codecs.geometry.BBox3D), slider-vs-hinge
interaction points (:566-572), the flip_x + negative-depth unprojection
(:315-367, :693), and the 90deg-z "CAD3D sync" world-coordinate rotation
(:705-710)."""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from a3vlm_tpu_torch.codecs.geometry import BBox3D, matrix_to_rotvec, rotvec_to_matrix

EPS = 1e-8


# -- point cloud --------------------------------------------------------------


def get_pointcloud(
    color, depth, mask, intrinsic, sample_size,
    flip_x: bool = False, flip_y: bool = False, enable_normal: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """(point_render.py:315-367). ``depth`` is signed camera-space z (the
    caller passes -depth). Returns (points, colors, normals, masks)."""
    rng = rng or np.random.default_rng()
    height, width = depth.shape
    px, py = np.meshgrid(np.arange(width), np.arange(height))
    px = px.astype(np.float64)
    py = py.astype(np.float64)
    if flip_x:
        px = width - 1 - px
    if flip_y:
        py = height - 1 - py
    px = (px - intrinsic[0, 2]) * (depth / intrinsic[0, 0])
    py = (py - intrinsic[1, 2]) * (depth / intrinsic[1, 1])
    points = np.stack([px, py, depth], axis=-1).reshape(-1, 3).astype(
        np.float32
    )
    colors = color.reshape(-1, 3)
    masks = mask.reshape(-1, 1)
    pc = np.hstack([points, colors, masks])
    pc = pc[pc[:, 0] != 0.0, :]
    if pc.shape[0] == 0:
        return None, None, None, None
    points, colors, masks = pc[:, :3], pc[:, 3:6], pc[:, 6]
    if points.shape[0] > sample_size:
        idx = rng.choice(points.shape[0], sample_size, replace=False)
        points, colors, masks = points[idx], colors[idx], masks[idx]
    if enable_normal:
        normals = estimate_normals_for_cloud(points)
    else:
        normals = np.zeros_like(points)
    return points, colors, normals, masks


def estimate_normals_for_cloud(
    points: np.ndarray, k: int = 10, camera_location=np.zeros(3)
) -> np.ndarray:
    """KDTree + SVD normal estimation, camera-oriented
    (point_render.py:279-306)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    normals = np.zeros_like(points)
    for i in range(len(points)):
        nb = points[idx[i]]
        centered = nb - nb.mean(axis=0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        n = vt[-1]
        if np.dot(n, points[i] - camera_location) > 0:
            n = -n
        normals[i] = n
    return normals


def jitter_brightness(colors, brightness_range=(0.8, 1.2), rng=None):
    rng = rng or np.random.default_rng()
    factor = rng.uniform(*brightness_range)
    return np.clip(colors * factor, 0, 255)


def vector_fix(vec) -> np.ndarray:
    """None components -> 0 (point_render.py:505-511)."""
    return np.array([0 if v is None else v for v in vec], np.float64)


# -- 3D labels ------------------------------------------------------------------


def generate_label_3d(
    points, colors, normals, masks, joint_info, semantic_data,
    camera_pose_inv, data_name,
) -> dict:
    """(point_render.py:514-586)."""
    label_3d: dict = {}
    for link_idx, link_data in enumerate(joint_info):
        if not ("jointData" in link_data and link_data["jointData"]):
            continue
        joint_type = semantic_data[link_idx]["joint_type"]
        if joint_type in ("fixed", "free", "heavy"):
            continue
        axis_origin = vector_fix(link_data["jointData"]["axis"]["origin"])
        axis_direction = vector_fix(
            link_data["jointData"]["axis"]["direction"]
        )
        axis_direction = axis_direction / (
            np.linalg.norm(axis_direction) + EPS
        )
        # y-up -> z-up (point_render.py:528-530)
        axis_origin = np.array(
            [-axis_origin[2], -axis_origin[0], axis_origin[1]]
        )
        axis_direction = np.array(
            [-axis_direction[2], -axis_direction[0], axis_direction[1]]
        )
        # joint frame: z along the axis (:532-543)
        joint_z = axis_direction
        joint_x = (
            np.array([1.0, 0.0, 0.0])
            if abs(joint_z[0]) < 0.9
            else np.array([0.0, 1.0, 0.0])
        )
        joint_y = np.cross(joint_z, joint_x)
        joint_y = joint_y / (np.linalg.norm(joint_y) + EPS)
        joint_x = np.cross(joint_y, joint_z)
        joint_x = joint_x / (np.linalg.norm(joint_x) + EPS)
        joint_T = np.eye(4)
        joint_T[:3, :3] = np.array([joint_x, joint_y, joint_z]).T
        joint_T[:3, 3] = axis_origin
        joint_T = camera_pose_inv @ joint_T
        joint_T_inv = np.linalg.inv(joint_T)

        joint_id = link_data["id"]
        pcd_id = np.where(masks == joint_id)[0]
        if len(pcd_id) == 0:
            continue
        mask_pcd = points[pcd_id]
        mask_pcd = mask_pcd @ joint_T_inv[:3, :3].T + joint_T_inv[:3, 3]

        bbox = BBox3D()
        if mask_pcd.shape[0] >= 8:
            bbox.create_minimum_projected_bbox(mask_pcd)
        else:
            bbox.create_axis_aligned_from_points(mask_pcd)

        min_z, max_z = mask_pcd[:, 2].min(), mask_pcd[:, 2].max()
        if joint_type == "slider":
            c = np.array(bbox.center)
            inter_points = np.array(
                [[c[0], c[1], min_z], [c[0], c[1], max_z]]
            )
        else:
            inter_points = np.array([[0, 0, min_z], [0, 0, max_z]])
        inter_points = inter_points @ joint_T[:3, :3].T + joint_T[:3, 3]
        bbox.rotate(joint_T[:3, :3], np.zeros(3))
        bbox.translate(joint_T[:3, 3])
        bbox_rep = np.concatenate(
            [bbox.center, bbox.extent, matrix_to_rotvec(bbox.R)]
        )
        label_3d[joint_id] = {
            "joint_T": joint_T.tolist(),
            "bbox_3d": bbox_rep.tolist(),
            "itp_points": inter_points.tolist(),
            "name": link_data["name"],
        }
    return label_3d


# -- per-object driver -----------------------------------------------------------


def _save_ply(path, points, normals, colors):
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, n, c in zip(points, normals, colors.astype(int)):
            f.write(
                f"{p[0]} {p[1]} {p[2]} {n[0]} {n[1]} {n[2]} "
                f"{c[0]} {c[1]} {c[2]}\n"
            )


def process_one_data(
    data_name: str,
    output_dir: str,
    use_world_coordinate: bool = True,
    sample_size: int = 32768,
    gaussian_noise: float = 0.002,
    save_label_3d: bool = True,
    enable_normal: bool = False,
    enable_aug: bool = False,
    export_ply: bool = False,
    export_npy: bool = False,
    npy_points: int = 8192,
    seed: int = 0,
) -> bool:
    """(point_render.py:589-750)."""
    import cv2

    rng = np.random.default_rng(seed)
    out = os.path.join(output_dir, data_name)
    color_dir = os.path.join(out, "raw_images")
    depth_dir = os.path.join(out, "real_depth_images")
    mask_dir = os.path.join(out, "mask")
    semantic_file = os.path.join(out, "semantics.txt")
    if not all(
        os.path.exists(p)
        for p in (color_dir, depth_dir, mask_dir, semantic_file)
    ):
        print(f"Skip {data_name} since not all files exist")
        return False

    pcd_dir = os.path.join(out, "pointclouds")
    npy_dir = os.path.join(out, f"npy_{npy_points}")
    for d in (pcd_dir, npy_dir):
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)

    try:
        semantic_data = []
        with open(semantic_file) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) == 3:
                    semantic_data.append(
                        {
                            "link_name": parts[0],
                            "joint_type": parts[1],
                            "semantic": parts[2],
                        }
                    )
        with open(os.path.join(out, "mobility_v2.json")) as f:
            joint_info = json.load(f)
        joint_info = [j for j in joint_info if j["joint"] != "junk"]
        with open(os.path.join(out, "info.json")) as f:
            info = json.load(f)

        cam = info["camera_info"]
        intrinsics = np.array(
            [
                [cam["fx"], 0, cam["cx"]],
                [0, cam["fy"], cam["cy"]],
                [0, 0, 1],
            ]
        )
        num_images = len(info["camera_poses"])
        label_3d_dicts = []
        for image_idx in range(num_images):
            color = cv2.imread(
                os.path.join(color_dir, f"{image_idx:06}.png")
            )
            color = cv2.cvtColor(color, cv2.COLOR_BGR2RGB)
            depth = (
                cv2.imread(
                    os.path.join(depth_dir, f"{image_idx:06}.png"),
                    cv2.IMREAD_ANYDEPTH,
                ).astype(np.float32)
                / 1000.0
            )
            mask = cv2.imread(
                os.path.join(mask_dir, f"{image_idx:06}.png"),
                cv2.IMREAD_UNCHANGED,
            ).astype(np.uint8)
            # mask holds part ids; remap to joint ids (:679-685)
            new_mask = np.zeros_like(mask)
            for mask_id in np.unique(mask):
                if mask_id == 0:
                    continue
                new_mask[mask == mask_id] = int(
                    joint_info[mask_id - 1]["id"]
                )

            camera_pose = np.array(
                info["camera_poses"][image_idx]
            ).reshape(4, 4)
            points, colors, normals, masks = get_pointcloud(
                color, -depth, new_mask, intrinsics, sample_size,
                flip_x=True, enable_normal=enable_normal, rng=rng,
            )
            if points is None:
                continue
            points = points + rng.normal(0, gaussian_noise, points.shape)
            normals = normals + rng.normal(0, gaussian_noise, normals.shape)
            colors = jitter_brightness(colors, rng=rng)

            if use_world_coordinate:
                disturbance = np.eye(4)
                random_rot_angle = (
                    rng.uniform(-20, 20) if enable_aug else 0.0
                )
                if enable_aug:
                    disturbance[:3, 3] = rng.uniform(-0.2, 0.2, 3)
                angle = np.deg2rad(90 + random_rot_angle)
                disturbance[:3, :3] = rotvec_to_matrix(
                    np.array([0, 0, angle])
                )
                dist_camera_pose = disturbance @ camera_pose
                points = (
                    points @ dist_camera_pose[:3, :3].T
                    + dist_camera_pose[:3, 3]
                )
                normals = normals @ dist_camera_pose[:3, :3].T
            else:
                disturbance = np.linalg.inv(camera_pose)

            label_3d = {}
            if save_label_3d:
                label_3d = generate_label_3d(
                    points, colors, normals, masks, joint_info,
                    semantic_data, disturbance, data_name,
                )
            label_3d["meta"] = {
                "disturbance": disturbance.tolist(),
                "camera_pose": camera_pose.tolist(),
            }
            label_3d_dicts.append(label_3d)

            if export_ply:
                _save_ply(
                    os.path.join(pcd_dir, f"{image_idx:06}.ply"),
                    points, normals, colors,
                )
            if export_npy:
                from a3vlm_tpu_torch.data.transforms import farthest_point_sample

                pc = np.concatenate([points, colors / 255.0], axis=1)
                pc = farthest_point_sample(pc, npy_points)
                np.save(
                    os.path.join(
                        npy_dir, f"{image_idx:06}_{npy_points}.npy"
                    ),
                    pc.astype(np.float32),
                )

        with open(os.path.join(out, "annotations_3d.json"), "w") as f:
            json.dump(label_3d_dicts, f)
        return True
    except Exception as e:
        print(f"Error in {data_name}: {e}")
        return False


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("depth -> point cloud + 3D triads")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_name", default="all")
    p.add_argument("--sample_size", type=int, default=32768)
    p.add_argument("--gaussian_noise", type=float, default=0.002)
    p.add_argument("--export_ply", action="store_true")
    p.add_argument("--export_npy", action="store_true")
    p.add_argument("--enable_aug", action="store_true")
    args = p.parse_args(argv)

    names = (
        [args.data_name]
        if args.data_name != "all"
        else sorted(
            d
            for d in os.listdir(args.output_dir)
            if os.path.isdir(os.path.join(args.output_dir, d))
        )
    )
    ok = 0
    for name in names:
        if process_one_data(
            name, args.output_dir, sample_size=args.sample_size,
            gaussian_noise=args.gaussian_noise, export_ply=args.export_ply,
            export_npy=args.export_npy, enable_aug=args.enable_aug,
        ):
            ok += 1
    print(f"processed {ok}/{len(names)} objects")


if __name__ == "__main__":
    main()
