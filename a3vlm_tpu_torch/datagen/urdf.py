"""URDF parsing, repair, and forward kinematics — replaces the reference's
urdfpy dependency (render_robot_pyrender.py:11,81-121) plus its urdf_fixer.py.

Only the URDF subset PartNet-Mobility uses is implemented: links with
visual/collision mesh geometries, and fixed/revolute/continuous/prismatic
joints with origins, axes and limits.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def modify_urdf(file_path: str) -> Optional[bool]:
    """URDF repair (reference data_gen/urdf_fixer.py:7-31): inject missing
    effort/velocity attributes into <limit> tags and replace literal None
    with 0. In-place."""
    try:
        with open(file_path) as f:
            lines = []
            for line in f:
                if line.strip().startswith("<limit"):
                    if "effort=" not in line or "velocity=" not in line:
                        line = re.sub(
                            r"(<limit)(.*?>)",
                            r'\1 effort="30" velocity="1.0"\2',
                            line,
                        )
                lines.append(line)
            lines = [re.sub(r"None", "0", x) for x in lines]
        with open(file_path, "w") as f:
            f.writelines(lines)
        return True
    except FileNotFoundError:
        print(f"Error: The file '{file_path}' was not found.")
        return None
    except Exception as e:  # pragma: no cover
        print(f"An error occurred: {e}")
        return None


def _origin_to_matrix(elem) -> np.ndarray:
    T = np.eye(4)
    if elem is None:
        return T
    xyz = elem.get("xyz")
    rpy = elem.get("rpy")
    if xyz:
        T[:3, 3] = [float(v) for v in xyz.split()]
    if rpy:
        r, p, y = (float(v) for v in rpy.split())
        cr, sr = np.cos(r), np.sin(r)
        cp, sp = np.cos(p), np.sin(p)
        cy, sy = np.cos(y), np.sin(y)
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        T[:3, :3] = Rz @ Ry @ Rx
    return T


@dataclass
class Geometry:
    origin: np.ndarray  # 4x4
    mesh_file: Optional[str] = None
    scale: Optional[np.ndarray] = None
    box_size: Optional[np.ndarray] = None  # primitive box fallback


@dataclass
class Link:
    name: str
    visuals: list[Geometry] = field(default_factory=list)
    collisions: list[Geometry] = field(default_factory=list)


@dataclass
class Limit:
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0


@dataclass
class Joint:
    name: str
    joint_type: str
    parent: str
    child: str
    origin: np.ndarray
    axis: np.ndarray
    limit: Optional[Limit] = None

    @property
    def type(self):  # urdfpy compat
        return self.joint_type


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, float)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.eye(3)
    k = axis / n
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


class URDF:
    def __init__(self, name: str, links: list[Link], joints: list[Joint]):
        self.name = name
        self.links = links
        self.joints = joints
        self._link_map = {l.name: l for l in links}
        self._children = {j.child: j for j in joints}

    @classmethod
    def load(cls, path: str) -> "URDF":
        tree = ET.parse(path)
        root = tree.getroot()
        base_dir = os.path.dirname(os.path.abspath(path))

        links = []
        for lnk in root.findall("link"):
            link = Link(name=lnk.get("name"))
            for kind, store in (
                ("visual", link.visuals),
                ("collision", link.collisions),
            ):
                for geom_parent in lnk.findall(kind):
                    origin = _origin_to_matrix(geom_parent.find("origin"))
                    geometry = geom_parent.find("geometry")
                    if geometry is None:
                        continue
                    mesh = geometry.find("mesh")
                    box = geometry.find("box")
                    if mesh is not None:
                        scale = mesh.get("scale")
                        store.append(
                            Geometry(
                                origin=origin,
                                mesh_file=os.path.join(
                                    base_dir, mesh.get("filename")
                                ),
                                scale=(
                                    np.array(
                                        [float(v) for v in scale.split()]
                                    )
                                    if scale
                                    else None
                                ),
                            )
                        )
                    elif box is not None:
                        store.append(
                            Geometry(
                                origin=origin,
                                box_size=np.array(
                                    [float(v) for v in box.get("size").split()]
                                ),
                            )
                        )
            links.append(link)

        joints = []
        for jnt in root.findall("joint"):
            axis_el = jnt.find("axis")
            axis = (
                np.array([float(v) for v in axis_el.get("xyz").split()])
                if axis_el is not None
                else np.array([1.0, 0.0, 0.0])
            )
            limit_el = jnt.find("limit")
            limit = None
            if limit_el is not None:
                limit = Limit(
                    lower=float(limit_el.get("lower", 0) or 0),
                    upper=float(limit_el.get("upper", 0) or 0),
                    effort=float(limit_el.get("effort", 0) or 0),
                    velocity=float(limit_el.get("velocity", 0) or 0),
                )
            joints.append(
                Joint(
                    name=jnt.get("name"),
                    joint_type=jnt.get("type"),
                    parent=jnt.find("parent").get("link"),
                    child=jnt.find("child").get("link"),
                    origin=_origin_to_matrix(jnt.find("origin")),
                    axis=axis,
                    limit=limit,
                )
            )
        return cls(root.get("name", "robot"), links, joints)

    @property
    def actuated_joints(self) -> list[Joint]:
        return [
            j
            for j in self.joints
            if j.joint_type in ("revolute", "continuous", "prismatic")
        ]

    @property
    def base_link(self) -> str:
        children = {j.child for j in self.joints}
        roots = [l.name for l in self.links if l.name not in children]
        assert roots, "no root link"
        return roots[0]

    def joint_transform(self, joint: Joint, value: float) -> np.ndarray:
        T = np.eye(4)
        if joint.joint_type in ("revolute", "continuous"):
            T[:3, :3] = _axis_angle_matrix(joint.axis, value)
        elif joint.joint_type == "prismatic":
            T[:3, 3] = np.asarray(joint.axis, float) * value
        return joint.origin @ T

    def link_fk(self, cfg: Optional[dict[str, float]] = None) -> dict[str, np.ndarray]:
        """{link_name: world 4x4} for the joint configuration (the urdfpy
        link_fk used at render_robot_pyrender.py:113-121)."""
        cfg = cfg or {}
        poses = {self.base_link: np.eye(4)}
        remaining = list(self.joints)
        while remaining:
            progressed = False
            for j in list(remaining):
                if j.parent in poses:
                    value = cfg.get(j.name, 0.0)
                    poses[j.child] = poses[j.parent] @ self.joint_transform(
                        j, value
                    )
                    remaining.remove(j)
                    progressed = True
            if not progressed:
                # disconnected subtree: anchor at identity
                for j in remaining:
                    poses.setdefault(j.parent, np.eye(4))
                    break
        for l in self.links:
            poses.setdefault(l.name, np.eye(4))
        return poses


def compute_kinematic_level(robot: URDF) -> int:
    """(render_robot_pyrender.py:26-40): depth of actuated-joint nesting.
    Level > 1 means hierarchical joints; the reference then zeroes all joint
    values (:106-108)."""
    kinematic: dict[str, int] = {robot.base_link: 0}
    actuated = {j.name for j in robot.actuated_joints}
    joints = list(robot.joints)
    for _ in range(len(joints)):
        for j in list(joints):
            if j.parent in kinematic and j.child not in kinematic:
                if j.name in actuated and not j.parent.endswith("helper"):
                    kinematic[j.child] = kinematic[j.parent] + 1
                else:
                    kinematic[j.child] = kinematic[j.parent]
                joints.remove(j)
    return max(kinematic.values()) if kinematic else 0
