"""3D box geometry for the triad annotations — the BBox3D math of reference
data_gen/point_render.py:42-192, re-implemented on numpy + cv2 (shapely /
scipy.spatial.transform replaced by cv2.minAreaRect and a local Rodrigues
rotation).

Conventions carried over exactly (they are part of the output contract,
SURVEY.md §2.3):
- corner enumeration order (point_render.py:138-153),
- pinhole projection with the **negated x** (`-x/z`) and positive y/z
  (point_render.py:165-178),
- depth normalized to the scene [depth_min, depth_max] and clipped to [0,1],
- minimum-projected OBB: 2D min-rotated-rect in the joint frame x z-extent,
  with the axis-aligned fallback for near-circular footprints
  (point_render.py:67-119).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-6


def rotvec_to_matrix(rot_vec: np.ndarray) -> np.ndarray:
    """Rodrigues rotation (scipy.spatial.transform.R.from_rotvec)."""
    rot_vec = np.asarray(rot_vec, dtype=np.float64)
    theta = np.linalg.norm(rot_vec)
    if theta < 1e-12:
        return np.eye(3)
    k = rot_vec / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def matrix_to_rotvec(Rm: np.ndarray) -> np.ndarray:
    """Inverse Rodrigues (R.from_matrix(...).as_rotvec)."""
    Rm = np.asarray(Rm, dtype=np.float64)
    cos_theta = np.clip((np.trace(Rm) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near-pi: extract axis from R + I
        A = (Rm + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0))
        # fix signs using off-diagonals
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        axis = axis / (np.linalg.norm(axis) + EPS)
        return axis * theta
    axis = (
        np.array(
            [Rm[2, 1] - Rm[1, 2], Rm[0, 2] - Rm[2, 0], Rm[1, 0] - Rm[0, 1]]
        )
        / (2.0 * np.sin(theta))
    )
    return axis * theta


def min_rotated_rect_2d(points_xy: np.ndarray):
    """Minimum-area rotated rectangle of 2D points via cv2
    (shapely MultiPoint.minimum_rotated_rectangle equivalent).
    Returns the 4 corner coords [4, 2] (closed ring excluded)."""
    import cv2

    pts = np.asarray(points_xy, dtype=np.float32)
    rect = cv2.minAreaRect(pts)
    return cv2.boxPoints(rect).astype(np.float64)


class BBox3D:
    """Oriented 3D box: center, extent, rotation."""

    def __init__(self, center=None, extent=None, rot_vec=None):
        self.extent = np.ones(3) if extent is None else np.asarray(extent, float)
        self.center = np.zeros(3) if center is None else np.asarray(center, float)
        self.R = np.eye(3) if rot_vec is None else rotvec_to_matrix(rot_vec)

    # -- constructors -------------------------------------------------------

    def create_axis_aligned_from_points(self, points: np.ndarray) -> None:
        min_b = points.min(axis=0)
        max_b = points.max(axis=0)
        self.center = (min_b + max_b) / 2
        self.extent = max_b - min_b
        self.R = np.eye(3)

    def create_minimum_projected_bbox(self, points: np.ndarray) -> None:
        """Min 2D rotated rect over xy x full z-extent, with the
        near-circular axis-aligned fallback (point_render.py:67-119)."""
        rect = min_rotated_rect_2d(points[:, :2])
        edges = [rect[(i + 1) % 4] - rect[i] for i in range(3)]
        longest = max(edges, key=np.linalg.norm)
        shortest = min(edges, key=np.linalg.norm)
        longest_len = float(np.linalg.norm(longest))
        shortest_len = float(np.linalg.norm(shortest))
        center_xy = rect.mean(axis=0)
        min_z, max_z = points[:, 2].min(), points[:, 2].max()

        if (longest_len - shortest_len) / (shortest_len + EPS) < 0.1:
            # near-square footprint: maybe a circle -> try axis-aligned
            aa_extent = points.max(axis=0) - points.min(axis=0)
            l_aa, s_aa = np.max(aa_extent[:2]), np.min(aa_extent[:2])
            if (
                abs(l_aa - longest_len) / (longest_len + EPS) < 0.1
                and abs(s_aa - shortest_len) / (shortest_len + EPS) < 0.1
            ):
                return self.create_axis_aligned_from_points(points)

        x_axis = np.array([longest[0], longest[1], 0.0])
        x_axis /= np.linalg.norm(x_axis) + EPS
        z_axis = np.array([0.0, 0.0, 1.0])
        y_axis = np.cross(z_axis, x_axis)
        self.center = np.array([center_xy[0], center_xy[1], (min_z + max_z) / 2])
        self.extent = np.array([longest_len, shortest_len, max_z - min_z])
        self.R = np.array([x_axis, y_axis, z_axis]).T

    # -- transforms ---------------------------------------------------------

    def rotate(self, Rm, center=np.zeros(3)):
        self.center = Rm @ (self.center - center) + center
        self.R = Rm @ self.R

    def translate(self, T):
        self.center = self.center + np.asarray(T)

    def transform(self, T):
        self.center = T[:3, :3] @ self.center + T[:3, 3]
        self.R = T[:3, :3] @ self.R

    # -- accessors ----------------------------------------------------------

    def get_points(self) -> np.ndarray:
        """Corner enumeration in the reference order
        (point_render.py:138-153)."""
        x = self.R @ np.array([self.extent[0] / 2, 0, 0])
        y = self.R @ np.array([0, self.extent[1] / 2, 0])
        z = self.R @ np.array([0, 0, self.extent[2] / 2])
        c = self.center
        return np.array(
            [
                c - x - y - z,
                c + x - y - z,
                c - x + y - z,
                c - x - y + z,
                c + x + y + z,
                c - x + y + z,
                c + x - y + z,
                c + x + y - z,
            ]
        )

    def get_array(self) -> np.ndarray:
        return np.concatenate([self.center, self.extent, matrix_to_rotvec(self.R)])

    def get_pose(self) -> np.ndarray:
        pose = np.eye(4)
        pose[:3, :3] = self.R
        pose[:3, 3] = self.center
        return pose

    # -- projection ---------------------------------------------------------

    def get_bbox_3d_proj(
        self, intrinsics, camera_pose, depth_min, depth_max, img_width, img_height
    ) -> np.ndarray:
        return project_points(
            self.get_points(), intrinsics, camera_pose, depth_min, depth_max,
            img_width, img_height,
        )


def project_points(
    points, intrinsics, camera_pose, depth_min, depth_max, img_width, img_height
) -> np.ndarray:
    """World points -> normalized pixel-space triples [x, y, z_norm] with the
    reference's -x/z convention and scene-depth normalization
    (point_render.py:165-192). Clipped to [0, 1]."""
    points = np.asarray(points, dtype=np.float64)
    cam = points @ camera_pose[:3, :3].T + camera_pose[:3, 3]
    x = -cam[:, 0] / cam[:, 2]
    y = cam[:, 1] / cam[:, 2]
    px = (x * intrinsics[0, 0] + intrinsics[0, 2]) / img_width
    py = (y * intrinsics[1, 1] + intrinsics[1, 2]) / img_height
    pz = (np.abs(cam[:, 2]) - depth_min) / (depth_max - depth_min + 1e-6)
    return np.clip(np.stack([px, py, pz], axis=1), 0, 1)


def normalize_and_round_angle(
    theta: float, granularity: int = 5, range_start: int = 0, range_end: int = 360
) -> float:
    """Quantize a degree angle to the granularity grid and return radians
    (partnet_label.py:139-147 — part of the 2D box string contract)."""
    theta_normalized = (theta - range_start) % (range_end - range_start) + range_start
    rounded = round(theta_normalized / granularity) * granularity
    if rounded == range_end:
        rounded = range_start
    return rounded / 180 * np.pi
