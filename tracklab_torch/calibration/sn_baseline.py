"""SoccerNet calibration baseline: direct camera estimation and camera
evaluation on the host, in numpy (counterpart of
tracklab_tpu.calibration.sn_baseline).

* :func:`estimate_homography_from_markings`: straight pitch markings seen
  in the image are fit to image lines, paired with their world lines on the
  z = 0 pitch, and a line DLT solves the plane homography (world line
  L ~ H^T l for every pair).
* :func:`camera_from_homography`: homography -> camera, focal length from
  the image of the absolute conic with the principal point at the image
  centre, then R and t from the scaled columns, R orthogonalised by SVD.
* :func:`camera_to_latent`: the camera as TVCalib's z-scored latent, the
  warm start that ``calibration/tvcalib.py:optimize_cameras(init_latents=
  ...)`` takes (the baseline-then-refine chain).
* :func:`evaluate_camera_prediction` and :func:`summarize_camera_eval`: the
  per-class confusion at a pixel threshold, the reprojection errors and
  the accuracy the SoccerNet camera evaluation reports.
"""
from __future__ import annotations

import numpy as np
import torch

from tracklab_torch.calibration.pitch import pitch_segments

__all__ = ["estimate_homography_from_markings",
           "camera_from_homography", "camera_to_latent",
           "evaluate_camera_prediction", "summarize_camera_eval"]

# segments that are straight world lines (usable for line-DLT);
# circles are excluded from the direct estimation, as in the baseline
_STRAIGHT = None


def _straight_segments():
    global _STRAIGHT
    if _STRAIGHT is None:
        _STRAIGHT = {n: p for n, p in pitch_segments().items()
                     if "circle" not in n}
    return _STRAIGHT


def _fit_image_line(points):
    """Total-least-squares line through 2D points -> (a, b, c) with
    a^2 + b^2 = 1 and a x + b y + c = 0."""
    pts = np.asarray(points, float)
    mean = pts.mean(axis=0)
    d = pts - mean
    _, _, vh = np.linalg.svd(d, full_matrices=False)
    n = vh[-1]                      # normal of the best-fit line
    n = n / np.linalg.norm(n)
    return np.array([n[0], n[1], -n @ mean])


def _world_line(seg_points):
    """(N, 3) collinear world points on z=0 -> homogeneous 2D line."""
    p0, p1 = seg_points[0][:2], seg_points[-1][:2]
    l = np.cross([p0[0], p0[1], 1.0], [p1[0], p1[1], 1.0])
    return l / np.linalg.norm(l[:2])


def estimate_homography_from_markings(observations: dict,
                                      min_lines: int = 4):
    """Detected pitch markings -> plane homography H (world z=0 ->
    image), or None when under-constrained.

    observations: segment_name -> (N, 2) image points. Each straight
    segment with >= 2 points contributes one line correspondence
    (image line l fit to the points, world line L from the template):
    L ~ H^T l gives two DLT rows. Requires >= ``min_lines``
    non-concurrent lines (the baseline needs >= 4 markings,
    baseline_cameras.py).
    """
    straight = _straight_segments()
    rows = []
    n_lines = 0
    for name, pts in observations.items():
        if name not in straight or len(pts) < 2:
            continue
        l_img = _fit_image_line(pts)
        L = _world_line(straight[name])
        # constraint: L x (H^T l) = 0 -> two independent equations,
        # unknowns h = vec(H) (9,)
        # (H^T l)_i = sum_j H_ji l_j ; write M h = lambda L
        HT_l = np.zeros((3, 9))
        for i in range(3):
            for j in range(3):
                HT_l[i, 3 * j + i] = l_img[j]
        # cross-product rows: L2*(HTl)_3 - L3*(HTl)_2 = 0 etc.
        c = np.array([[0, -L[2], L[1]],
                      [L[2], 0, -L[0]],
                      [-L[1], L[0], 0]])
        rows.append(c @ HT_l)
        n_lines += 1
    if n_lines < min_lines:
        return None
    A = np.concatenate(rows, axis=0)
    _, _, vh = np.linalg.svd(A)
    H = vh[-1].reshape(3, 3)
    # orient: a pitch point in front of the camera projects with w > 0
    if H[2, 2] < 0:
        H = -H
    return H / np.linalg.norm(H)


def _focal_from_homography(H, principal):
    """Focal length from the plane homography with the principal point
    pinned (camera.py:454 estimate_calibration_matrix_from_plane_
    homography solves the IAC least-squares; with square pixels and a
    known principal point this reduces to the two orthogonality
    constraints on K^-1 h1, K^-1 h2)."""
    cx, cy = principal
    # translate principal point to origin: H' = T^-1 H
    T = np.array([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]])
    Hp = np.linalg.inv(T) @ H
    h1, h2 = Hp[:, 0], Hp[:, 1]
    # with K = diag(f, f, 1): h1^T w h2 = 0 and h1^T w h1 = h2^T w h2,
    # w = diag(1, 1, f^2) up to scale -> solve for f^2
    a = h1[0] * h2[0] + h1[1] * h2[1]
    b = h1[2] * h2[2]
    c = (h1[0] ** 2 + h1[1] ** 2) - (h2[0] ** 2 + h2[1] ** 2)
    d = h1[2] ** 2 - h2[2] ** 2
    cands = []
    if abs(b) > 1e-12:
        cands.append(-a / b)
    if abs(d) > 1e-12:
        cands.append(-c / d)
    cands = [v for v in cands if v > 1.0]
    if not cands:
        return None
    return float(np.sqrt(np.mean(cands)))


def camera_from_homography(H, image_dim=(1920, 1080)):
    """Plane homography -> CameraParams (pan/tilt/roll/focal/position).

    K from the image of the absolute conic, then H' = K^-1 H gives
    [r1 r2 t] up to scale; R orthogonalised by SVD; C = -R^T t. Returns
    None on degeneracy. The angles are read in the port's camera convention
    (``calibration/camera.py:_rotation``) from the rotation's rows; the
    fields are float64 tensors on the CPU (the host solve's precision).
    """
    from tracklab_torch.calibration.camera import CameraParams

    W, Himg = image_dim
    principal = (W / 2.0, Himg / 2.0)
    f = _focal_from_homography(H, principal)
    if f is None or not np.isfinite(f):
        return None
    K = np.array([[f, 0, principal[0]], [0, f, principal[1]],
                  [0, 0, 1.0]])
    Hp = np.linalg.inv(K) @ H
    l1 = 1.0 / np.linalg.norm(Hp[:, 0])
    l2 = 1.0 / np.linalg.norm(Hp[:, 1])
    l3 = np.sqrt(l1 * l2)
    r0 = Hp[:, 0] * l1
    r1 = Hp[:, 1] * l2
    r2 = np.cross(r0, r1)
    R = np.column_stack([r0, r1, r2])
    u, _, vh = np.linalg.svd(R)
    R = u @ vh
    if np.linalg.det(R) < 0:
        u[:, 2] *= -1
        R = u @ vh
    t = Hp[:, 2] * l3
    C = -R.T @ t
    if C[2] < 0:          # camera below the pitch: flip the scale sign
        t = -t
        C = -R.T @ t
    # R maps world -> camera with rows [right; down; forward]... except
    # the plane-homography R has columns for (x, y, z-world); forward is
    # row 2 of R
    fwd = R[2]
    tilt = float(np.arccos(np.clip(-fwd[2], -1.0, 1.0)))
    pan = float(np.arctan2(fwd[0], -fwd[1]))
    # roll: compare the actual right axis with the roll-free one
    up = np.array([0.0, 0.0, 1.0])
    r0_free = np.cross(fwd, up)
    n = np.linalg.norm(r0_free)
    if n < 1e-8:
        roll = 0.0
    else:
        r0_free /= n
        d0_free = np.cross(fwd, r0_free)
        roll = float(np.arctan2(R[0] @ d0_free, R[0] @ r0_free))
    f64 = dict(dtype=torch.float64)
    return CameraParams(
        pan=torch.tensor(pan, **f64), tilt=torch.tensor(tilt, **f64),
        roll=torch.tensor(roll, **f64), focal=torch.tensor(f, **f64),
        position=torch.tensor(C, **f64),
        principal=torch.tensor([principal[0], principal[1]], **f64))


def camera_to_latent(cam, priors, cfg):
    """CameraParams -> z-scored latent (9,) for warm-starting the
    tvcalib GD (the baseline-then-refine chain). priors (9, 2) from
    cam_distr.priors_array; distortion latents start at 0."""
    aov = 2.0 * np.arctan((cfg.image_width / 2.0) / float(cam.focal))
    vals = np.array([
        float(cam.pan), float(cam.tilt), float(cam.roll), aov,
        float(cam.position[0]), float(cam.position[1]),
        -float(cam.position[2]), 0.0, 0.0])
    priors = np.asarray(priors)
    std = np.where(priors[:, 1] > 1e-9, priors[:, 1], 1.0)
    z = (vals - priors[:, 0]) / std
    z[7:] = 0.0
    return z


# ---------------------------------------------------------------------------
# camera evaluation (evaluate_camera.py:151-216)
# ---------------------------------------------------------------------------
def _distance_to_polyline(point, polyline):
    """L2 distance from a point to a sampled polyline (segment-wise,
    evaluate_camera.py:104-148)."""
    p = np.asarray(point, float)
    poly = np.asarray(polyline, float)
    if len(poly) == 1:
        return float(np.linalg.norm(p - poly[0]))
    a = poly[:-1]
    b = poly[1:]
    ab = b - a
    denom = np.maximum((ab * ab).sum(axis=1), 1e-12)
    t = np.clip(((p - a) * ab).sum(axis=1) / denom, 0.0, 1.0)
    proj = a + t[:, None] * ab
    return float(np.linalg.norm(proj - p, axis=1).min())


def evaluate_camera_prediction(projected_lines: dict,
                               groundtruth_lines: dict,
                               threshold: float):
    """Confusion matrices + per-class reprojection errors, the exact
    accounting of evaluate_camera.py:151-216: a GT class counts as
    correctly detected when EVERY GT point lies within ``threshold``
    px of the predicted polyline."""
    global_confusion = np.zeros((2, 2), np.float32)
    per_class = {}
    errors = {}
    detected = set(projected_lines)
    gt = set(groundtruth_lines)
    for cls in detected - gt:
        fp = 2.0 if "circle" not in cls.lower() else 9.0
        per_class[cls] = np.array([[0.0, fp], [0.0, 0.0]])
        global_confusion[0, 1] += 1
    for cls in gt - detected:
        fn = float(len(groundtruth_lines[cls]))
        per_class[cls] = np.array([[0.0, 0.0], [fn, 0.0]])
        global_confusion[1, 0] += 1
    for cls in detected & gt:
        per_class[cls] = np.zeros((2, 2))
        all_below = True
        for point in groundtruth_lines[cls]:
            d = _distance_to_polyline(point, projected_lines[cls])
            errors.setdefault(cls, []).append(d)
            if d < threshold:
                per_class[cls][0, 0] += 1
            else:
                per_class[cls][0, 1] += 1
                all_below = False
        if all_below:
            global_confusion[0, 0] += 1
        else:
            global_confusion[0, 1] += 1
    return global_confusion, per_class, errors


def summarize_camera_eval(global_confusion, errors):
    """Acc@t (correct classes / evaluated classes) + mean reprojection
    error — the numbers the SoccerNet evaluation reports."""
    tp = global_confusion[0, 0]
    total = global_confusion.sum()
    acc = float(tp / total) if total else 0.0
    all_err = [e for v in errors.values() for e in v]
    return {"accuracy": acc,
            "mean_reprojection_error":
                float(np.mean(all_err)) if all_err else float("nan"),
            "median_reprojection_error":
                float(np.median(all_err)) if all_err else float("nan")}
