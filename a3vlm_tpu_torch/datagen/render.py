"""Scene rendering for datagen — the render_tools.py equivalent on the
native rasterizer (no pyrender/EGL).

Key behaviors carried over:
- camera-pose samplers: full sphere (:16-51) and the xy-band "front" sampler
  the A3VLM data uses (:54-90), with look-at jitter and up-vector noise
  (:203-210), radii scaled by the scene bounding sphere (:187-191).
- per-link annotations: axis-aligned bbox, cv2 minAreaRect rotated bbox of
  the largest visible contour, area, vis_ratio (visible px / alone px),
  3D center, camera pose (:240-297).
- outputs per view: color image (Lambert-shaded), full depth, link-id mask
  (link_idx + 1, 0 = background).

One z-buffer pass gives depth + per-pixel link ids, so the visible masks of
ALL links come from a single render; the reference's per-link re-render
(:240-257) is only reproduced for the un-occluded "alone" footprint needed
by vis_ratio.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from a3vlm_tpu_torch.datagen.mesh import TriMesh, concatenate
from a3vlm_tpu_torch.datagen.rasterizer import (
    rasterize,
    rasterize_uv,
    sample_textures,
    shade_albedo,
    shade_lambert,
)


def _look_at_matrix(cam_position, look_at, up):
    z_axis = -(look_at - cam_position)
    z_axis = z_axis / np.linalg.norm(z_axis)
    x_axis = np.cross(up, z_axis)
    x_axis = x_axis / np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    T = np.eye(4)
    T[:3, 0] = x_axis
    T[:3, 1] = y_axis
    T[:3, 2] = z_axis
    T[:3, 3] = cam_position
    return T


def sample_camera_pose(
    cam_radius_min, cam_radius_max, look_at, up, only_front=False,
    rng: Optional[np.random.Generator] = None,
):
    """Spherical sampler (render_tools.py:16-51). NOTE: the reference adds
    the offset to look_at twice (cam_position = look_at + [x,y,z] where
    x/y/z already include look_at) — reproduced faithfully since the
    training distribution depends on it."""
    rng = rng or np.random.default_rng()
    radius = rng.uniform(cam_radius_min, cam_radius_max)
    theta = rng.uniform(0, 2 * np.pi)
    phi = rng.uniform(0, np.pi)
    if only_front:
        x = -abs(radius * np.sin(phi) * np.cos(theta)) + look_at[0]
        y = abs(radius * np.sin(phi) * np.sin(theta)) + look_at[1]
        z = abs(radius * np.cos(phi)) + look_at[2]
    else:
        x = radius * np.sin(phi) * np.cos(theta) + look_at[0]
        y = radius * np.sin(phi) * np.sin(theta) + look_at[1]
        z = radius * np.cos(phi) + look_at[2]
    cam_position = look_at + np.array([x, y, z])
    return _look_at_matrix(cam_position, look_at, up)


def sample_camera_pose_xy(
    cam_radius_min, cam_radius_max, look_at, up, only_front=False,
    rng: Optional[np.random.Generator] = None,
):
    """xy-band sampler (render_tools.py:54-90)."""
    rng = rng or np.random.default_rng()
    radius = rng.uniform(cam_radius_min, cam_radius_max)
    if only_front:
        theta = rng.uniform(np.pi * 0.6, np.pi * 1.4)
        phi = rng.uniform(0.23 * np.pi, 0.26 * np.pi)
    else:
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(-0.25 * np.pi, 0.25 * np.pi)
    x = radius * np.cos(theta) * np.cos(phi) + look_at[0]
    y = radius * np.sin(theta) * np.cos(phi) + look_at[1]
    z = radius * np.sin(phi) + look_at[2]
    cam_position = look_at + np.array([x, y, z])
    return _look_at_matrix(cam_position, look_at, up)


def _min_area_rect(mask: np.ndarray):
    """cv2 minAreaRect of the largest visible contour
    (render_tools.py:242-249). Returns (cx, cy, w, h, angle_deg)."""
    import cv2

    contours, _ = cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    largest = max(contours, key=cv2.contourArea)
    rect = cv2.minAreaRect(largest)
    return (rect[0][0], rect[0][1], rect[1][0], rect[1][1], rect[2])


def render_parts(
    mesh_map: dict[str, tuple[TriMesh, np.ndarray]],  # name -> (mesh, pose)
    num_cam_poses: int,
    camera_info: dict,
    cam_radius_max: float,
    cam_radius_min: float,
    image_idx_offset: int = 0,
    only_front: bool = False,
    camera_sample_method: str = "xy",
    predefine_camera_poses=None,
    is_link_map: bool = True,
    rng: Optional[np.random.Generator] = None,
):
    """Returns (annotations, camera_poses, color_imgs, depth_imgs, mask_imgs),
    the render_tools.render_parts contract (:126-309). ``mesh_map`` maps
    link names (ending in ``_{idx}``) to (mesh, world pose)."""
    rng = rng or np.random.default_rng()
    fx, fy = camera_info["fx"], camera_info["fy"]
    cx, cy = camera_info["cx"], camera_info["cy"]
    width, height = camera_info["width"], camera_info["height"]

    # world-space scene assembly with per-face link ids
    world_meshes = []
    link_names = []
    centers_3d = {}
    for name, (m, pose) in mesh_map.items():
        wm = m.copy().apply_transform(pose)
        world_meshes.append(wm)
        link_names.append(name)
        centers_3d[name] = (
            pose[:3, :3] @ m.vertices.mean(axis=0) + pose[:3, 3]
        )
    scene = concatenate(world_meshes)
    face_link = np.concatenate(
        [
            np.full(len(m.faces), i, np.int32)
            for i, m in enumerate(world_meshes)
        ]
    )
    if is_link_map:
        # random flat color per link (render_tools.py:166-169)
        link_colors = rng.random((len(world_meshes), 3))
        face_colors = link_colors[face_link]
    else:
        face_colors = scene.face_colors

    center = np.mean([m.centroid for m in world_meshes], axis=0)
    radius = max(
        np.max(np.linalg.norm(m.vertices - center, axis=1))
        for m in world_meshes
    )
    r_min = radius * cam_radius_min
    r_max = radius * cam_radius_max

    annotations = []
    camera_poses = []
    color_imgs, depth_imgs, mask_imgs = [], [], []

    for img_idx in range(num_cam_poses):
        look_at = np.zeros(3) + rng.normal(scale=0.1 * radius, size=3)
        up = np.array([0.0, 0.0, 1.0]) + rng.normal(scale=0.07 * np.pi, size=3)
        up /= np.linalg.norm(up)
        if predefine_camera_poses is not None:
            camera_pose = np.asarray(
                predefine_camera_poses[image_idx_offset + img_idx]
            )
        elif camera_sample_method == "uniform":
            camera_pose = sample_camera_pose(
                r_min, r_max, look_at, up, only_front, rng
            )
        else:
            camera_pose = sample_camera_pose_xy(
                r_min, r_max, look_at, up, only_front, rng
            )
        camera_poses.append(
            camera_pose.tolist()
            if isinstance(camera_pose, np.ndarray)
            else camera_pose
        )

        world_to_cam = np.linalg.inv(np.asarray(camera_pose))
        v_cam = scene.vertices @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]

        normals = scene.face_normals()
        lights = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
        if not is_link_map and scene.has_textures:
            # visual pass with map_Kd textures: UV-interpolating raster +
            # per-pixel texture sampling (pyrender's textured render,
            # render_tools.py:166-185)
            full_depth, face_idx, link_idx_map, uv = rasterize_uv(
                v_cam, scene.faces, face_link, scene.face_uvs,
                fx, fy, cx, cy, width, height,
            )
            albedo = sample_textures(
                face_idx, uv, scene.face_texture, scene.textures,
                np.asarray(face_colors),
            )
            color = shade_albedo(normals, albedo, face_idx, lights)
        else:
            full_depth, face_idx, link_idx_map = rasterize(
                v_cam, scene.faces, face_link, fx, fy, cx, cy, width, height
            )
            # color: flat Lambert shading with 3 axis lights
            color = shade_lambert(normals, face_colors, face_idx, lights)
        color_imgs.append(color)

        if not is_link_map:
            continue
        depth_imgs.append(full_depth)

        mask_img = np.zeros((height, width), np.uint8)
        for li, name in enumerate(link_names):
            mask_vis = link_idx_map == li
            if not mask_vis.any():
                continue
            # "alone" footprint: rasterize only this link's faces
            sel = face_link == li
            alone_depth, _, _ = rasterize(
                v_cam, scene.faces[sel], None, fx, fy, cx, cy, width, height
            )
            mask_all = alone_depth > 0
            vis_ratio = mask_vis.sum() / (mask_all.sum() + 1e-6)

            rect = _min_area_rect(mask_vis)
            ys, xs = np.where(mask_vis)
            x_min, x_max = int(xs.min()), int(xs.max())
            y_min, y_max = int(ys.min()), int(ys.max())
            link_id = int(name.split("_")[-1])
            mask_img[mask_vis] = link_id + 1
            annotations.append(
                {
                    "bbox": [x_min, y_min, x_max - x_min, y_max - y_min],
                    "rot_bbox": list(rect),
                    "area": int((x_max - x_min) * (y_max - y_min)),
                    "vis_ratio": float(vis_ratio),
                    "center_3d": centers_3d[name].tolist(),
                    "image_id": img_idx + image_idx_offset,
                    "id": link_id,
                    "name": name,
                    "camera_pose": camera_poses[-1],
                }
            )
        mask_imgs.append(mask_img)

    return annotations, camera_poses, color_imgs, depth_imgs, mask_imgs
