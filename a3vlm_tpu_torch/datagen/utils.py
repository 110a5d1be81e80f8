"""2D geometry + visualization helpers (reference data_gen/utils.py), with
cv2 replacing shapely for rotated-box construction/IoU."""

from __future__ import annotations

import random

import numpy as np

COLORS = {
    "red": (0, 0, 255),
    "green": (0, 255, 0),
    "blue": (255, 0, 0),
    "yellow": (0, 255, 255),
    "cyan": (255, 255, 0),
    "magenta": (255, 0, 255),
    "gray": (128, 128, 128),
    "orange": (0, 165, 255),
    "purple": (128, 0, 128),
    "brown": (19, 69, 139),
    "pink": (147, 20, 255),
}


def get_rotated_box_points(cx, cy, w, h, angle_deg) -> np.ndarray:
    """Corner points of a rotated rect (shapely rotate+translate equivalent,
    utils.py:31-38)."""
    import cv2

    return cv2.boxPoints(((cx, cy), (w, h), angle_deg))


def rotated_box_iou(box1, box2) -> float:
    """IoU of two (cx, cy, w, h, angle_deg) rotated boxes
    (utils.py:41-48 via shapely -> cv2.rotatedRectangleIntersection)."""
    import cv2

    r1 = ((box1[0], box1[1]), (box1[2], box1[3]), box1[4])
    r2 = ((box2[0], box2[1]), (box2[2], box2[3]), box2[4])
    ret, region = cv2.rotatedRectangleIntersection(r1, r2)
    if ret == cv2.INTERSECT_NONE or region is None:
        inter = 0.0
    else:
        inter = cv2.contourArea(region)
    a1 = box1[2] * box1[3]
    a2 = box2[2] * box2[3]
    # cv2's float32 intersection can exceed either area by rounding at
    # large coordinates (observed IoU 1.0004) — clamp the invariant
    inter = min(inter, a1, a2)
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def draw_rotating_bbox(img, bbox, angle, color=(0, 255, 0), thickness=2,
                       text=None):
    """(utils.py:51-91: radians in, degrees to cv2, None-angle =
    'Perpendicular' convention)."""
    import cv2

    center, size = (int(bbox[0]), int(bbox[1])), (int(bbox[2]), int(bbox[3]))
    if angle is None or angle in ("none", "None"):
        angle = 0
        text = "None Angle" if text is None else "Perpendicular_" + text
    angle = angle * 180 / np.pi
    rect_coords = cv2.boxPoints(
        ((center[0], center[1]), (size[0], size[1]), angle)
    ).astype(np.int64)
    cv2.drawContours(img, [rect_coords], 0, color, thickness)
    if text is not None:
        bottom_left = (
            int(bbox[0] - bbox[2] / 2 - 5), int(bbox[1] + bbox[3] / 2 + 5)
        )
        cv2.putText(img, text, bottom_left, cv2.FONT_HERSHEY_SIMPLEX, 2.5,
                    color, 2, cv2.LINE_AA)
    return img


def draw_rotating_bboxs_with_text(img, list_bbox_name, thickness=2):
    for name, bbox in list_bbox_name:
        color = random.choice(list(COLORS.values()))
        img = draw_rotating_bbox(
            img, bbox[:4], bbox[4], color, thickness, text=name
        )
    return img


def intersect_line_bbox(origin, direction, bbox):
    """Slab-test line/axis-aligned-bbox intersection (utils.py:94-127)."""
    x_center, y_center, width, height = bbox
    x_min, x_max = x_center - width / 2, x_center + width / 2
    y_min, y_max = y_center - height / 2, y_center + height / 2
    origin = np.asarray(origin, float)
    direction = np.asarray(direction, float)

    if not np.any(direction != 0):
        # degenerate (zero) direction: no line to intersect — the
        # unguarded slab test returns [nan, nan] for inside origins
        return None
    tmin, tmax = float("-inf"), float("inf")
    bounds = [(x_min, x_max), (y_min, y_max)]
    for i in range(2):
        if direction[i] != 0:
            t1 = (bounds[i][0] - origin[i]) / direction[i]
            t2 = (bounds[i][1] - origin[i]) / direction[i]
            tmin = max(tmin, min(t1, t2))
            tmax = min(tmax, max(t1, t2))
        elif origin[i] < bounds[i][0] or origin[i] > bounds[i][1]:
            return None
    if tmin > tmax:
        return None
    intersection = origin + tmin * direction
    if intersection[1] < y_min or intersection[1] > y_max:
        return None
    return intersection


def convert_depth_to_color(depth_img, maintain_ratio=False):
    """uint16 depth -> JET colorized uint8 (utils.py:130-142).
    ``maintain_ratio``: fixed 2000-unit window above the min depth
    (utils.py:133-134) so colors stay comparable across frames."""
    import cv2

    d = depth_img.astype(np.float32)
    valid = d > 0
    if valid.any():
        dmin = d[valid].min()
        dmax = dmin + 2000.0 if maintain_ratio else d[valid].max()
        norm = np.zeros_like(d)
        norm[valid] = np.clip(
            (d[valid] - dmin) / (dmax - dmin + 1e-6), 0.0, 1.0
        )
    else:
        norm = np.zeros_like(d)
    u8 = (norm * 255).astype(np.uint8)
    color = cv2.applyColorMap(u8, cv2.COLORMAP_JET)
    color[~valid] = 0
    return color


def read_ply_ascii(path: str) -> np.ndarray:
    """Minimal ascii PLY reader (utils.py:146-165)."""
    with open(path) as f:
        lines = f.readlines()
    n = 0
    header_end = 0
    for i, line in enumerate(lines):
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        if line.strip() == "end_header":
            header_end = i + 1
            break
    data = [
        [float(v) for v in lines[header_end + i].split()] for i in range(n)
    ]
    return np.asarray(data, np.float32)


# -- exact 3D OBB IoU (scoring; no reference analog — the paper's 3D
# detection metric family is IoU-based but the reference repo dumps raw
# records without scoring, eval_affordance_v2.py:386-401) -----------------


def _box_halfspaces(corners: np.ndarray):
    """(A, b) of _box_halfspaces_vol — kept for callers/tests that only
    need the half-spaces."""
    A, b, _ = _box_halfspaces_vol(corners)
    return A, b


def _box_halfspaces_vol(corners: np.ndarray):
    """[8, 3] box corners (ANY labeling order) -> (A [6, 3], b [6], vol)
    with the box = {x : A @ x <= b}, rows unit-norm; ``vol`` is the slab
    polytope's volume when it was computed during candidate selection
    (None when only a degenerate candidate exists).

    Axis recovery is order-free and picks the MINIMUM-VOLUME of two
    complementary candidates (any slab set containing all 8 corners has
    volume >= the box volume, with equality exactly at the true axes —
    so min-volume provably recovers a true box):

    - PCA: for a true box the centered corners are {+-a1 +-a2 +-a3}, so
      their covariance is R^T diag(|a_i|^2) R and the eigenvectors ARE
      the axes — for any corner labeling, and CONTINUOUSLY in corner
      perturbations (matters for the perspective-projected 8-corner
      answers, which are warped hexahedra: pred~=gt must keep IoU~=1,
      which discrete neighbor-pick rules break). Fails on eigen-ties
      (cube-like extents: isotropic covariance hides the rotation).
    - Greedy orthogonal edges: shortest corner-0 vector is an edge; the
      shortest vector orthogonal to picks recovers the rest (a face
      diagonal of two orthogonal edges is longer than either). Exact on
      cubes; fails on elongated boxes (a short-edge face diagonal can
      undercut the long edge). Exactly PCA's complement."""
    c = np.asarray(corners, np.float64)

    def slabs(dirs):
        A, b = [], []
        for e in dirs:
            proj = c @ e
            if proj.max() - proj.min() < 1e-12:
                continue  # flat direction: no bounded slab
            A.append(e)
            b.append(proj.max())
            A.append(-e)
            b.append(-proj.min())
        return np.asarray(A), np.asarray(b)

    cands = []
    centered = c - c.mean(0)
    try:
        _, vecs = np.linalg.eigh(centered.T @ centered)
        cands.append(slabs(vecs.T))
    except np.linalg.LinAlgError:
        pass
    vecs7 = c[1:] - c[0]
    lens = np.linalg.norm(vecs7, axis=1)
    picked = []
    for cos_tol in (0.2, 0.5):  # relax for badly skewed model output
        for j in np.argsort(lens):
            if lens[j] < 1e-12 or len(picked) == 3:
                continue
            u = vecs7[j] / lens[j]
            if all(abs(np.dot(u, e)) < cos_tol for e in picked):
                picked.append(u)
        if len(picked) == 3:
            break
    if picked:
        cands.append(slabs(picked))
    # cands[0] is PCA whenever eigh succeeded (the continuous candidate)
    full = [(A, b) for A, b in cands if len(A) == 6]
    if not full:
        A, b = cands[0] if cands else (np.zeros((0, 3)), np.zeros((0,)))
        return A, b, None
    if len(full) == 1:
        A, b = full[0]
        return A, b, _halfspace_volume(A, b)
    vols = [_halfspace_volume(A, b) for A, b in full]
    # PCA-PREFERRING rule: a hard argmin flips between the candidates
    # under ~1e-4 corner perturbations on warped hexahedra (observed:
    # IoU 0.76-0.88 for near-identical inputs — the GREEDY edge pick is
    # itself discontinuous, so its volume can jump across a twin pair
    # and drag the argmin with it). Take the greedy set only when it is
    # SUBSTANTIALLY tighter (>10%) — the case it exists for is the PCA
    # eigen-tie on cube-like true boxes, where the PCA slab is the AABB
    # of a rotated cube (~2x the volume), far beyond the margin. Inside
    # the margin PCA wins deterministically, so both sides of a
    # near-identical pair land on the same (continuous) axes.
    lo = 1 if vols[1] < 0.9 * vols[0] else 0
    A, b = full[lo]
    return A, b, vols[lo]


def _halfspace_volume(A: np.ndarray, b: np.ndarray) -> float:
    """Volume of the (bounded, convex) polytope {x : A @ x <= b} by vertex
    enumeration over plane triples + divergence-theorem face sums. Rows of
    A must be unit-norm. Returns 0.0 for empty/degenerate polytopes."""
    m = len(A)
    scale = max(float(np.abs(b).max()), 1.0)
    tol = 1e-9 * scale
    verts = []
    from itertools import combinations

    for i, j, k in combinations(range(m), 3):
        M = A[[i, j, k]]
        if abs(np.linalg.det(M)) < 1e-12:
            continue
        v = np.linalg.solve(M, b[[i, j, k]])
        if np.all(A @ v <= b + tol):
            verts.append(v)
    if len(verts) < 4:
        return 0.0
    V = np.asarray(verts)
    # dedupe (coincident plane-triple solutions at box corners)
    kept = []
    for v in V:
        if not any(np.linalg.norm(v - u) < 10 * tol for u in kept):
            kept.append(v)
    V = np.asarray(kept)
    if len(V) < 4:
        return 0.0
    vol = 0.0
    for i in range(m):
        # duplicate / near-duplicate half-spaces (e.g. the two boxes of a
        # self-IoU, or coplanar pred/GT faces) must contribute ONE face.
        # The dedup window must EQUAL the on-face window: smaller and a
        # pair offset inside (dedup, face) double-counts the face (both
        # planes see the binding plane's vertices); larger and the
        # binding plane is dropped while the looser one finds no on-face
        # vertices, losing the face entirely. At equality, a non-deduped
        # pair's looser plane sits >= face_tol from the vertices and
        # collects nothing; a deduped pair's survivor collects the face
        # whichever of the two it is (the pair is within face_tol).
        face_tol = 100 * tol
        if any(
            np.dot(A[i], A[j]) > 1.0 - 1e-9
            and abs(b[i] - b[j]) < face_tol
            for j in range(i)
        ):
            continue
        on = V[np.abs(V @ A[i] - b[i]) < face_tol]
        if len(on) < 3:
            continue
        n = A[i]  # outward unit normal
        cen = on.mean(0)
        # order the face polygon by angle in-plane
        u = on[0] - cen
        un = np.linalg.norm(u)
        if un < 1e-12:
            continue
        u = u / un
        w = np.cross(n, u)
        ang = np.arctan2((on - cen) @ w, (on - cen) @ u)
        P = on[np.argsort(ang)]
        # fan triangulation; divergence theorem: V = 1/3 sum (x . n) dA
        for t in range(1, len(P) - 1):
            a_, b_, c_ = P[0], P[t], P[t + 1]
            area_vec = 0.5 * np.cross(b_ - a_, c_ - a_)
            vol += float(np.dot((a_ + b_ + c_) / 3.0, area_vec))
    return max(vol / 3.0, 0.0)


def obb_prep(corners: np.ndarray):
    """Per-box precomputation for repeated IoU evaluation: (A, b, volume),
    or None for degenerate boxes. Matching loops (detection3d scoring)
    evaluate O(P*G) pairs — the half-spaces and own-volume are per-box
    invariants and must not be recomputed per pair."""
    A, b, v = _box_halfspaces_vol(corners)
    if len(A) < 6:
        return None
    if v is None:
        v = _halfspace_volume(A, b)
    return (A, b, v) if v > 0.0 else None


def obb_iou_3d_prepped(pa, pb) -> float:
    """IoU from two obb_prep results (either may be None -> 0.0)."""
    if pa is None or pb is None:
        return 0.0
    Aa, ba, va = pa
    Ab, bb, vb = pb
    vi = _halfspace_volume(
        np.concatenate([Aa, Ab]), np.concatenate([ba, bb])
    )
    return float(vi / max(va + vb - vi, 1e-12))


def obb_iou_3d(corners_a: np.ndarray, corners_b: np.ndarray) -> float:
    """Exact IoU of two 3D oriented boxes given as [8, 3] corner arrays
    (any corner order). Intersection is the 12-half-space polytope; all
    three volumes run through the same exact vertex-enumeration routine.
    Validated against Monte-Carlo sampling to <1% (tests)."""
    return obb_iou_3d_prepped(obb_prep(corners_a), obb_prep(corners_b))
