"""Triangle-mesh IO and ops — replaces the reference's trimesh dependency
(render_robot_pyrender.py:10, mesh concatenate/transform/export at :149-161).

Supports the PartNet-Mobility asset subset: Wavefront OBJ with MTL diffuse
colors AND ``map_Kd`` texture maps (the reference renders textured meshes
through pyrender's visual pass, render_tools.py:166-185), vt texcoords,
fan triangulation, transforms, concatenation, OBJ export.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # [V, 3] float64
    faces: np.ndarray  # [F, 3] int32
    face_colors: Optional[np.ndarray] = None  # [F, 3] float in [0,1]
    # texture support (visual pass): per-face-corner texcoords, per-face
    # texture index into ``textures`` (-1 = untextured -> face_colors)
    face_uvs: Optional[np.ndarray] = None  # [F, 3, 2] float32
    face_texture: Optional[np.ndarray] = None  # [F] int32
    textures: list = field(default_factory=list)  # [th, tw, 3] uint8 images

    @property
    def centroid(self) -> np.ndarray:
        return self.vertices.mean(axis=0)

    @property
    def has_textures(self) -> bool:
        return (
            self.face_uvs is not None
            and self.face_texture is not None
            and len(self.textures) > 0
            and bool((self.face_texture >= 0).any())
        )

    def copy(self) -> "TriMesh":
        return TriMesh(
            self.vertices.copy(),
            self.faces.copy(),
            None if self.face_colors is None else self.face_colors.copy(),
            None if self.face_uvs is None else self.face_uvs.copy(),
            None if self.face_texture is None else self.face_texture.copy(),
            list(self.textures),
        )

    def apply_transform(self, T: np.ndarray) -> "TriMesh":
        self.vertices = self.vertices @ T[:3, :3].T + T[:3, 3]
        return self

    def apply_scale(self, scale) -> "TriMesh":
        self.vertices = self.vertices * np.asarray(scale, float)
        return self

    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norm, 1e-12)

    def export_obj(self, path: str) -> None:
        with open(path, "w") as fh:
            for v in self.vertices:
                fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for f in self.faces + 1:
                fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def _load_texture(path: str) -> Optional[np.ndarray]:
    """Texture image as RGB uint8 [h, w, 3] (cv2 host-side, like the rest of
    the datagen stack)."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            return None
        return np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB
    except Exception:
        return None


def _parse_mtl(path: str) -> tuple[dict, dict]:
    """-> ({material: Kd rgb}, {material: texture image or None})."""
    colors: dict[str, np.ndarray] = {}
    textures: dict[str, Optional[np.ndarray]] = {}
    if not os.path.isfile(path):
        return colors, textures
    base = os.path.dirname(os.path.abspath(path))
    current = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                current = parts[1]
            elif parts[0] == "Kd" and current:
                colors[current] = np.array([float(x) for x in parts[1:4]])
            elif parts[0] == "map_Kd" and current:
                # last token is the filename (options like -s may precede)
                tex = _load_texture(os.path.join(base, parts[-1]))
                if tex is not None:
                    textures[current] = tex
    return colors, textures


def load_obj(path: str) -> TriMesh:
    """OBJ reader: v / vt / f (fan-triangulated) with mtllib/usemtl diffuse
    colors and map_Kd textures. vn indices ignored (flat shading)."""
    vertices: list[list[float]] = []
    texcoords: list[list[float]] = []
    faces: list[list[int]] = []
    face_colors: list[np.ndarray] = []
    face_uvs: list[np.ndarray] = []
    face_texture: list[int] = []
    mtl_colors: dict[str, np.ndarray] = {}
    mtl_textures: dict[str, np.ndarray] = {}
    textures: list[np.ndarray] = []
    tex_index: dict[str, int] = {}
    current_color = np.array([0.7, 0.7, 0.7])
    current_tex = -1
    base = os.path.dirname(os.path.abspath(path))
    no_uv = np.zeros((3, 2), np.float32)

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                texcoords.append([float(parts[1]), float(parts[2])])
            elif tag == "mtllib":
                c, t = _parse_mtl(os.path.join(base, parts[1]))
                mtl_colors.update(c)
                mtl_textures.update(t)
            elif tag == "usemtl":
                current_color = mtl_colors.get(parts[1], current_color)
                if parts[1] in mtl_textures:
                    if parts[1] not in tex_index:
                        tex_index[parts[1]] = len(textures)
                        textures.append(mtl_textures[parts[1]])
                    current_tex = tex_index[parts[1]]
                else:
                    current_tex = -1
            elif tag == "f":
                refs = [p.split("/") for p in parts[1:]]
                idx = [int(r[0]) for r in refs]
                idx = [i - 1 if i > 0 else len(vertices) + i for i in idx]
                vt = [
                    int(r[1]) - 1 if len(r) > 1 and r[1] else -1
                    for r in refs
                ]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    face_colors.append(current_color)
                    corners = (vt[0], vt[k], vt[k + 1])
                    if current_tex >= 0 and all(c >= 0 for c in corners):
                        face_uvs.append(
                            np.asarray(
                                [texcoords[c] for c in corners], np.float32
                            )
                        )
                        face_texture.append(current_tex)
                    else:
                        face_uvs.append(no_uv)
                        face_texture.append(-1)

    mesh = TriMesh(
        np.asarray(vertices, np.float64),
        np.asarray(faces, np.int32).reshape(-1, 3),
        np.asarray(face_colors, np.float64).reshape(-1, 3),
    )
    if textures:
        mesh.face_uvs = np.asarray(face_uvs, np.float32).reshape(-1, 3, 2)
        mesh.face_texture = np.asarray(face_texture, np.int32)
        mesh.textures = textures
    return mesh


def box_mesh(size) -> TriMesh:
    """Axis-aligned box primitive (URDF <box> geometries)."""
    sx, sy, sz = np.asarray(size, float) / 2
    v = np.array(
        [
            [-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
            [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz],
        ]
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom
            [4, 5, 6], [4, 6, 7],  # top
            [0, 1, 5], [0, 5, 4],
            [1, 2, 6], [1, 6, 5],
            [2, 3, 7], [2, 7, 6],
            [3, 0, 4], [3, 4, 7],
        ],
        np.int32,
    )
    colors = np.tile(np.array([0.7, 0.7, 0.7]), (len(f), 1))
    return TriMesh(v, f, colors)


def concatenate(meshes: list[TriMesh]) -> TriMesh:
    """(trimesh.util.concatenate at render_robot_pyrender.py:152-154);
    carries texture atlases through with re-indexed per-face texture ids."""
    verts, faces, colors, uvs, tex_ids = [], [], [], [], []
    textures: list[np.ndarray] = []
    offset = 0
    any_tex = any(m.has_textures for m in meshes)
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + offset)
        colors.append(
            m.face_colors
            if m.face_colors is not None
            else np.tile(np.array([0.7, 0.7, 0.7]), (len(m.faces), 1))
        )
        if any_tex:
            if m.has_textures:
                uvs.append(m.face_uvs)
                tex_ids.append(
                    np.where(
                        m.face_texture >= 0,
                        m.face_texture + len(textures),
                        -1,
                    )
                )
                textures.extend(m.textures)
            else:
                uvs.append(np.zeros((len(m.faces), 3, 2), np.float32))
                tex_ids.append(np.full(len(m.faces), -1, np.int32))
        offset += len(m.vertices)
    out = TriMesh(
        np.concatenate(verts), np.concatenate(faces), np.concatenate(colors)
    )
    if any_tex:
        out.face_uvs = np.concatenate(uvs).astype(np.float32)
        out.face_texture = np.concatenate(tex_ids).astype(np.int32)
        out.textures = textures
    return out


def load_link_mesh(geoms) -> Optional[TriMesh]:
    """Combined mesh of a link's geometry list (the urdfpy
    ``link.collision_mesh`` equivalent)."""
    parts = []
    for g in geoms:
        if g.mesh_file is not None:
            m = load_obj(g.mesh_file)
        elif g.box_size is not None:
            m = box_mesh(g.box_size)
        else:
            continue
        if g.scale is not None:
            m.apply_scale(g.scale)
        m.apply_transform(g.origin)
        parts.append(m)
    if not parts:
        return None
    return concatenate(parts)


YZ_SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64
)  # the y/z swap applied before mesh export (render_robot_pyrender.py:156-158)
