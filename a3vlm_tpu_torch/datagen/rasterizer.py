"""Rasterizer binding: compiles the native C++ z-buffer rasterizer on first
use (ctypes; no pybind11 in this image) with a vectorized numpy fallback.

Camera convention (shared with codecs/geometry.project_points and
point_render's unprojection): camera looks along -Z; ``px = fx*X/|Z| + cx``,
``py = -fy*Y/|Z| + cy``, depth = |Z|.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from functools import lru_cache
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "rasterizer.cpp")


@lru_cache(maxsize=1)
def _load_native():
    # built into the package's git-ignored build directory under a name of
    # its own (not the JAX package's shared temp-dir library), written to a
    # temporary name and renamed, so processes building at once never load
    # a half-written file
    build_dir = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "_build")
    lib_path = os.path.join(build_dir, "liba3vlm_torch_rasterizer.so")
    try:
        if not os.path.exists(lib_path) or os.path.getmtime(
            lib_path
        ) < os.path.getmtime(_SRC):
            os.makedirs(build_dir, exist_ok=True)
            fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            try:
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", _SRC, "-o",
                        tmp_path,
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp_path, lib_path)
            finally:
                if os.path.exists(tmp_path):
                    os.remove(tmp_path)
        lib = ctypes.CDLL(lib_path)
    except Exception:
        return None
    lib.rasterize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rasterize.restype = None
    lib.rasterize_uv.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.rasterize_uv.restype = None
    return lib


def rasterize(
    vertices_cam: np.ndarray,  # [V, 3] camera-space
    faces: np.ndarray,  # [F, 3] int32
    face_ids: Optional[np.ndarray],  # [F] int32 payload (e.g. link index)
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    force_numpy: bool = False,
):
    """Returns (depth [H,W] f32 with 0=empty, face_idx [H,W] i32 -1=empty,
    id [H,W] i32 -1=empty)."""
    vertices_cam = np.ascontiguousarray(vertices_cam, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if face_ids is None:
        face_ids = np.arange(len(faces), dtype=np.int32)
    face_ids = np.ascontiguousarray(face_ids, np.int32)

    lib = None if force_numpy else _load_native()
    if lib is not None:
        depth = np.zeros((height, width), np.float32)
        face_out = np.full((height, width), -1, np.int32)
        id_out = np.full((height, width), -1, np.int32)
        lib.rasterize(
            vertices_cam.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(vertices_cam),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            face_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(faces),
            fx, fy, cx, cy, width, height,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            face_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            id_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return depth, face_out, id_out
    return _rasterize_numpy(
        vertices_cam, faces, face_ids, fx, fy, cx, cy, width, height
    )


def _rasterize_numpy(v, faces, face_ids, fx, fy, cx, cy, width, height):
    """Vectorized-per-triangle numpy fallback (same math as the C++)."""
    d = -v[:, 2]
    valid_v = d > 1e-9
    px = np.where(valid_v, fx * (v[:, 0] / np.maximum(d, 1e-9)) + cx, -1e9)
    py = np.where(valid_v, -fy * (v[:, 1] / np.maximum(d, 1e-9)) + cy, -1e9)

    zbuf = np.full((height, width), np.inf, np.float32)
    depth = np.zeros((height, width), np.float32)
    face_out = np.full((height, width), -1, np.int32)
    id_out = np.full((height, width), -1, np.int32)

    for t in range(len(faces)):
        i0, i1, i2 = faces[t]
        if not (valid_v[i0] and valid_v[i1] and valid_v[i2]):
            continue
        x0, y0, x1, y1, x2, y2 = px[i0], py[i0], px[i1], py[i1], px[i2], py[i2]
        x_lo = max(0, int(np.floor(min(x0, x1, x2))))
        x_hi = min(width - 1, int(np.ceil(max(x0, x1, x2))))
        y_lo = max(0, int(np.floor(min(y0, y1, y2))))
        y_hi = min(height - 1, int(np.ceil(max(y0, y1, y2))))
        if x_lo > x_hi or y_lo > y_hi:
            continue
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if abs(area) < 1e-12:
            continue
        ys, xs = np.mgrid[y_lo : y_hi + 1, x_lo : x_hi + 1]
        pxc = xs + 0.5
        pyc = ys + 0.5
        w0 = ((x1 - pxc) * (y2 - pyc) - (x2 - pxc) * (y1 - pyc)) / area
        w1 = ((x2 - pxc) * (y0 - pyc) - (x0 - pxc) * (y2 - pyc)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz = w0 / d[i0] + w1 / d[i1] + w2 / d[i2]
        z = np.where(iz > 0, 1.0 / np.maximum(iz, 1e-12), np.inf)
        tile = zbuf[y_lo : y_hi + 1, x_lo : x_hi + 1]
        win = inside & (z < tile)
        tile[win] = z[win].astype(np.float32)
        depth[y_lo : y_hi + 1, x_lo : x_hi + 1][win] = z[win]
        face_out[y_lo : y_hi + 1, x_lo : x_hi + 1][win] = t
        id_out[y_lo : y_hi + 1, x_lo : x_hi + 1][win] = face_ids[t]
    return depth, face_out, id_out


def rasterize_uv(
    vertices_cam: np.ndarray,  # [V, 3] camera-space
    faces: np.ndarray,  # [F, 3] int32
    face_ids: Optional[np.ndarray],
    face_uvs: np.ndarray,  # [F, 3, 2] float32 per-corner texcoords
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    force_numpy: bool = False,
):
    """Textured rasterization: (depth, face_idx, id, uv [H,W,2]) with
    perspective-correct texcoord interpolation (the visual pass of the
    reference's pyrender textured render, render_tools.py:166-185)."""
    vertices_cam = np.ascontiguousarray(vertices_cam, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if face_ids is None:
        face_ids = np.arange(len(faces), dtype=np.int32)
    face_ids = np.ascontiguousarray(face_ids, np.int32)
    face_uvs = np.ascontiguousarray(face_uvs, np.float32)
    assert face_uvs.shape == (len(faces), 3, 2), face_uvs.shape

    lib = None if force_numpy else _load_native()
    if lib is not None:
        depth = np.zeros((height, width), np.float32)
        face_out = np.full((height, width), -1, np.int32)
        id_out = np.full((height, width), -1, np.int32)
        uv_out = np.zeros((height, width, 2), np.float32)
        lib.rasterize_uv(
            vertices_cam.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(vertices_cam),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            face_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            face_uvs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(faces),
            fx, fy, cx, cy, width, height,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            face_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            id_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            uv_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return depth, face_out, id_out, uv_out
    return _rasterize_uv_numpy(
        vertices_cam, faces, face_ids, face_uvs, fx, fy, cx, cy,
        width, height,
    )


def _rasterize_uv_numpy(v, faces, face_ids, face_uvs, fx, fy, cx, cy,
                        width, height):
    """Numpy fallback with the same perspective-correct uv math."""
    d = -v[:, 2]
    valid_v = d > 1e-9
    px = np.where(valid_v, fx * (v[:, 0] / np.maximum(d, 1e-9)) + cx, -1e9)
    py = np.where(valid_v, -fy * (v[:, 1] / np.maximum(d, 1e-9)) + cy, -1e9)

    zbuf = np.full((height, width), np.inf, np.float32)
    depth = np.zeros((height, width), np.float32)
    face_out = np.full((height, width), -1, np.int32)
    id_out = np.full((height, width), -1, np.int32)
    uv_out = np.zeros((height, width, 2), np.float32)

    for t in range(len(faces)):
        i0, i1, i2 = faces[t]
        if not (valid_v[i0] and valid_v[i1] and valid_v[i2]):
            continue
        x0, y0, x1, y1, x2, y2 = px[i0], py[i0], px[i1], py[i1], px[i2], py[i2]
        x_lo = max(0, int(np.floor(min(x0, x1, x2))))
        x_hi = min(width - 1, int(np.ceil(max(x0, x1, x2))))
        y_lo = max(0, int(np.floor(min(y0, y1, y2))))
        y_hi = min(height - 1, int(np.ceil(max(y0, y1, y2))))
        if x_lo > x_hi or y_lo > y_hi:
            continue
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if abs(area) < 1e-12:
            continue
        ys, xs = np.mgrid[y_lo : y_hi + 1, x_lo : x_hi + 1]
        pxc = xs + 0.5
        pyc = ys + 0.5
        w0 = ((x1 - pxc) * (y2 - pyc) - (x2 - pxc) * (y1 - pyc)) / area
        w1 = ((x2 - pxc) * (y0 - pyc) - (x0 - pxc) * (y2 - pyc)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        iz0, iz1, iz2 = 1.0 / d[i0], 1.0 / d[i1], 1.0 / d[i2]
        iz = w0 * iz0 + w1 * iz1 + w2 * iz2
        z = np.where(iz > 0, 1.0 / np.maximum(iz, 1e-12), np.inf)
        (u0, v0), (u1, v1), (u2, v2) = face_uvs[t]
        u = (w0 * u0 * iz0 + w1 * u1 * iz1 + w2 * u2 * iz2) * z
        vv = (w0 * v0 * iz0 + w1 * v1 * iz1 + w2 * v2 * iz2) * z
        tile = zbuf[y_lo : y_hi + 1, x_lo : x_hi + 1]
        win = inside & (z < tile)
        tile[win] = z[win].astype(np.float32)
        depth[y_lo : y_hi + 1, x_lo : x_hi + 1][win] = z[win]
        face_out[y_lo : y_hi + 1, x_lo : x_hi + 1][win] = t
        id_out[y_lo : y_hi + 1, x_lo : x_hi + 1][win] = face_ids[t]
        uv_out[y_lo : y_hi + 1, x_lo : x_hi + 1, 0][win] = u[win]
        uv_out[y_lo : y_hi + 1, x_lo : x_hi + 1, 1][win] = vv[win]
    return depth, face_out, id_out, uv_out


def sample_textures(
    face_idx: np.ndarray,  # [H, W] from rasterize_uv
    uv: np.ndarray,  # [H, W, 2]
    face_texture: np.ndarray,  # [F] int32 texture index, -1 untextured
    textures: list,  # of [th, tw, 3] uint8
    face_colors: np.ndarray,  # [F, 3] float fallback albedo
) -> np.ndarray:
    """Per-pixel albedo [H, W, 3] float in [0,1]: nearest-texel map_Kd
    sampling (OBJ convention: v axis flipped), flat Kd fallback."""
    H, W = face_idx.shape
    albedo = np.zeros((H, W, 3), np.float32)
    hit = face_idx >= 0
    f = face_idx[hit]
    albedo[hit] = face_colors[f]
    tex_of_pix = np.full((H, W), -1, np.int64)
    tex_of_pix[hit] = face_texture[f]
    for ti, tex in enumerate(textures):
        sel = tex_of_pix == ti
        if not sel.any():
            continue
        th, tw = tex.shape[:2]
        u = np.mod(uv[sel, 0], 1.0)
        v = np.mod(uv[sel, 1], 1.0)
        xi = np.clip((u * tw).astype(np.int64), 0, tw - 1)
        yi = np.clip(((1.0 - v) * th).astype(np.int64), 0, th - 1)
        albedo[sel] = tex[yi, xi].astype(np.float32) / 255.0
    return albedo


def shade_albedo(
    mesh_normals_world: np.ndarray,  # [F, 3]
    albedo: np.ndarray,  # [H, W, 3] float in [0,1]
    face_idx: np.ndarray,  # [H, W]
    light_dirs: np.ndarray,
    ambient: float = 0.35,
) -> np.ndarray:
    """Lambert shading of a per-pixel albedo buffer -> RGB uint8."""
    H, W = face_idx.shape
    img = np.zeros((H, W, 3), np.float32)
    hit = face_idx >= 0
    n = mesh_normals_world[face_idx[hit]]
    lambert = np.zeros(hit.sum(), np.float32)
    for ld in light_dirs:
        lambert += np.maximum(np.abs(n @ ld), 0.0) * (0.8 / len(light_dirs))
    shade = np.clip(ambient + lambert, 0, 1)[:, None]
    img[hit] = albedo[hit] * shade
    return (img * 255).astype(np.uint8)


def shade_lambert(
    mesh_normals_world: np.ndarray,  # [F, 3]
    face_colors: np.ndarray,  # [F, 3]
    face_idx: np.ndarray,  # [H, W] from rasterize
    light_dirs: np.ndarray,  # [L, 3] unit, pointing FROM surface TO light
    ambient: float = 0.35,
) -> np.ndarray:
    """Flat Lambertian shading of a rasterized id-buffer -> RGB uint8 [H,W,3].
    (The reference's 3 pyrender point lights, render_tools.py:148-160,
    approximated by directional lights — annotation-equivalent output.)"""
    H, W = face_idx.shape
    img = np.zeros((H, W, 3), np.float32)
    hit = face_idx >= 0
    f = face_idx[hit]
    n = mesh_normals_world[f]
    lambert = np.zeros(len(f), np.float32)
    for ld in light_dirs:
        lambert += np.maximum(np.abs(n @ ld), 0.0) * (0.8 / len(light_dirs))
    shade = np.clip(ambient + lambert, 0, 1)[:, None]
    img[hit] = face_colors[f] * shade
    return (img * 255).astype(np.uint8)
