"""Global (camera) motion compensation on the host (counterpart of
tracklab_tpu.motion.gmc's ``GMC`` and ``CameraMotion``).

Frame-pair registration as the reference's GMC (plugins/track/bot_sort/
gmc.py:80-317): OpenCV's ECC, sparse optical flow, ORB or SIFT features,
playback of a precomputed warp file, or the dense pyramidal Lucas-Kanade of
``motion/lk.py`` on the device the caller names ("lk_jax", the JAX
package's name for its device-side option, kept so configs carry over).
OpenCV is imported inside the methods that use it; "lk_jax" prepares its
frames with it (grayscale, downscale), as the JAX package does.
``CameraMotion`` is the pipeline module that runs a ``GMC`` over a video's
frames and emits each frame's warp as the image column ``gmc_warp``.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import ImageLevelModule
from tracklab_torch.utils.collate import Unbatchable, default_collate

log = logging.getLogger(__name__)

__all__ = ["GMC", "CameraMotion"]

IDENTITY = np.eye(2, 3, dtype=np.float32)


class GMC:
    """Frame-pair global motion estimator.

    methods: "sparseOptFlow" (goodFeaturesToTrack + pyramidal LK +
    estimateAffinePartial2D/RANSAC, gmc.py:239-303), "ecc"
    (findTransformECC euclidean, gmc.py:80-111), "orb" (FAST + ORB
    descriptors, Hamming BF matcher), "sift" (SIFT, L2 BF matcher), "file"
    (per-frame warp playback from a precomputed GMC-<seq>.txt,
    gmc.py:36-54, 305-317), "lk_jax" (the dense pyramidal LK of
    ``motion/lk.py`` on ``device``, ``cuda`` unless told otherwise), "none".

    For "file" pass either ``gmc_file`` (direct path) or ``gmc_file_dir`` +
    ``seq_name`` (MOTChallenge layout: the -FRCNN/-DPM/-SDP detector suffix
    is stripped and the file is ``GMC-<seq>.txt``, as in gmc.py:44-51).
    """

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2,
                 gmc_file=None, gmc_file_dir=None, seq_name=None,
                 device=None):
        self.method = method
        self.downscale = max(int(downscale), 1)
        self.device = device
        self._feat_cache = None  # (frame_ref, keypoints, descriptors)
        self._gmc_fh = None
        if method in ("file", "files"):
            self.method = "file"
            if gmc_file is None:
                if gmc_file_dir is None or seq_name is None:
                    raise ValueError(
                        "GMC(method='file') needs gmc_file or "
                        "gmc_file_dir + seq_name")
                for suffix in ("-FRCNN", "-DPM", "-SDP"):
                    if seq_name.endswith(suffix):
                        seq_name = seq_name[: -len(suffix)]
                        break
                gmc_file = os.path.join(gmc_file_dir, f"GMC-{seq_name}.txt")
            self._gmc_file_path = gmc_file
            self._gmc_fh = open(gmc_file, "r")

    def reset(self):
        """Start of a new video: rewind file playback to the first frame's
        warp and drop the feature cache."""
        self._feat_cache = None
        if self._gmc_fh is not None:
            self._gmc_fh.seek(0)

    def close(self):
        if self._gmc_fh is not None:
            self._gmc_fh.close()
            self._gmc_fh = None

    def _features(self, gray, frame_ref, detections=None):
        """FAST/ORB or SIFT keypoints and descriptors with the reference's
        2 % border mask and detection-box exclusion (gmc.py:126-133),
        cached by frame identity (the pipeline passes the same array as cur
        and then as prev)."""
        import cv2
        if (detections is None and self._feat_cache is not None
                and self._feat_cache[0] is frame_ref):
            return self._feat_cache[1], self._feat_cache[2]
        h, w = gray.shape
        mask = np.zeros_like(gray)
        mask[int(0.02 * h): int(0.98 * h), int(0.02 * w): int(0.98 * w)] = 255
        if detections is not None:
            for det in np.asarray(detections).reshape(-1, 4):
                l, t, r, b = (det / self.downscale).astype(int)
                mask[max(t, 0):max(b, 0), max(l, 0):max(r, 0)] = 0
        if self.method == "orb":
            detector = cv2.FastFeatureDetector_create(20)
            extractor = cv2.ORB_create()
        else:
            sift = cv2.SIFT_create(nOctaveLayers=3, contrastThreshold=0.02,
                                   edgeThreshold=20)
            detector = extractor = sift
        kps = detector.detect(gray, mask)
        kps, desc = extractor.compute(gray, kps)
        if detections is None:
            self._feat_cache = (frame_ref, kps, desc)
        return kps, desc

    def _apply_features(self, prev, cur, prev_dets=None,
                        cur_dets=None) -> np.ndarray:
        """ORB/SIFT registration (gmc.py:113-238): knn ratio match, a
        spatial-distance gate at 0.25 (W, H), a 2.5-sigma inlier filter
        (<=, so that a noiseless rigid warp keeps its matches),
        partial-affine RANSAC."""
        import cv2
        prev_g = self._prep(prev)
        cur_g = self._prep(cur)
        kp_p, d_p = self._features(prev_g, prev, prev_dets)
        kp_c, d_c = self._features(cur_g, cur, cur_dets)
        if d_p is None or d_c is None or len(kp_p) < 2 or len(kp_c) < 2:
            return IDENTITY.copy()
        norm = cv2.NORM_HAMMING if self.method == "orb" else cv2.NORM_L2
        knn = cv2.BFMatcher(norm).knnMatch(d_p, d_c, 2)
        h, w = prev_g.shape
        max_sd = 0.25 * np.array([w, h])
        matches, sds = [], []
        for pair in knn:
            if len(pair) < 2:
                continue
            m, n = pair
            if m.distance < 0.9 * n.distance:
                pp = kp_p[m.queryIdx].pt
                cp = kp_c[m.trainIdx].pt
                sd = (pp[0] - cp[0], pp[1] - cp[1])
                if abs(sd[0]) < max_sd[0] and abs(sd[1]) < max_sd[1]:
                    matches.append(m)
                    sds.append(sd)
        if not matches:
            return IDENTITY.copy()
        sds = np.asarray(sds)
        inlier = (sds - sds.mean(0)) <= 2.5 * sds.std(0)
        prev_pts, cur_pts = [], []
        for i, m in enumerate(matches):
            if inlier[i, 0] and inlier[i, 1]:
                prev_pts.append(kp_p[m.queryIdx].pt)
                cur_pts.append(kp_c[m.trainIdx].pt)
        if len(prev_pts) <= 4:
            log.debug("GMC %s: not enough matching points", self.method)
            return IDENTITY.copy()
        M, _ = cv2.estimateAffinePartial2D(np.asarray(prev_pts),
                                           np.asarray(cur_pts),
                                           method=cv2.RANSAC)
        if M is None:
            return IDENTITY.copy()
        return self._full_res(M.astype(np.float32))

    def _apply_file(self) -> np.ndarray:
        """The next precomputed warp (gmc.py:305-317: tab-separated ``t h00
        h01 h02 h10 h11 h12`` per frame)."""
        line = self._gmc_fh.readline()
        if not line.strip():
            return IDENTITY.copy()
        tok = line.split("\t")
        if len(tok) < 7:
            tok = line.split()
            tok = [""] + tok if len(tok) == 6 else tok
        H = np.eye(2, 3, dtype=np.float32)
        H[0, :] = [float(tok[1]), float(tok[2]), float(tok[3])]
        H[1, :] = [float(tok[4]), float(tok[5]), float(tok[6])]
        return H

    def _prep(self, frame):
        import cv2
        if frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        if self.downscale > 1:
            frame = cv2.resize(frame, (frame.shape[1] // self.downscale,
                                       frame.shape[0] // self.downscale))
        return frame

    def _full_res(self, H):
        """Scale the translation of a warp found on downscaled frames back
        to full resolution."""
        if self.downscale > 1:
            H = H.copy()
            H[0, 2] *= self.downscale
            H[1, 2] *= self.downscale
        return H

    def _apply_lk(self, prev, cur) -> np.ndarray:
        from tracklab_torch.motion.lk import estimate_affine_lk
        dev = resolve_device(self.device)
        H = estimate_affine_lk(torch.from_numpy(self._prep(prev)).to(dev),
                               torch.from_numpy(self._prep(cur)).to(dev))
        return self._full_res(H.cpu().numpy().astype(np.float32))

    def apply(self, prev, cur, prev_dets=None, cur_dets=None) -> np.ndarray:
        """A 2x3 affine warp mapping prev-frame coords to cur-frame coords
        (full resolution). ``prev_dets``/``cur_dets`` optionally mask
        detection boxes out of the orb/sift feature extraction
        (gmc.py:129-133)."""
        if self.method == "file":
            # one line per frame, the first frame's included, to stay in
            # step with the precomputed file
            return self._apply_file()
        if self.method == "none" or prev is None:
            return IDENTITY.copy()
        if self.method in ("orb", "sift"):
            return self._apply_features(prev, cur, prev_dets, cur_dets)
        if self.method == "lk_jax":
            return self._apply_lk(prev, cur)
        import cv2
        prev_g = self._prep(prev)
        cur_g = self._prep(cur)
        H = IDENTITY.copy()
        try:
            if self.method == "ecc":
                criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                            100, 1e-5)
                _, H = cv2.findTransformECC(prev_g, cur_g, H.copy(),
                                            cv2.MOTION_EUCLIDEAN, criteria,
                                            None, 1)
            elif self.method == "sparseOptFlow":
                pts = cv2.goodFeaturesToTrack(
                    prev_g, maxCorners=1000, qualityLevel=0.01,
                    minDistance=1, blockSize=3, useHarrisDetector=False,
                    k=0.04)
                if pts is None or len(pts) < 8:
                    return IDENTITY.copy()
                nxt, status, _ = cv2.calcOpticalFlowPyrLK(prev_g, cur_g, pts,
                                                          None)
                good = status.reshape(-1).astype(bool)
                if good.sum() < 8:
                    return IDENTITY.copy()
                M, _ = cv2.estimateAffinePartial2D(pts[good], nxt[good],
                                                   method=cv2.RANSAC)
                if M is not None:
                    H = M.astype(np.float32)
            else:
                raise ValueError(f"Unknown GMC method {self.method}")
        except cv2.error as e:  # a failed registration gives the identity
            log.debug("GMC failed (%s); identity warp", e)
            return IDENTITY.copy()
        return self._full_res(H).astype(np.float32)


class CameraMotion(ImageLevelModule):
    """Pipeline module: each frame's ``GMC`` warp from the previous frame
    (identity on a video's first frame), stored as the image-level column
    ``gmc_warp``, which the embedding trackers' wrappers read."""

    input_columns = []
    output_columns = {"image": ["gmc_warp"], "detection": []}
    collate_fn = staticmethod(default_collate)

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2,
                 batch_size: int = 4, device=None, gmc_file=None,
                 gmc_file_dir=None, seq_name=None, **kwargs):
        super().__init__(batch_size)
        self.gmc = GMC(method, downscale, gmc_file=gmc_file,
                       gmc_file_dir=gmc_file_dir, seq_name=seq_name,
                       device=device)
        self.reset()

    def reset(self):
        """Start of a new video."""
        self._prev = None
        self.gmc.reset()

    def preprocess(self, image, detections, metadata):
        return {"image": Unbatchable(image)}

    def process(self, batch, detections, metadatas: pd.DataFrame):
        """No detection rows; one image row per frame of the batch, in
        order."""
        warps = []
        for image, image_id in zip(batch["image"], metadatas.index):
            w = self.gmc.apply(self._prev, image)
            self._prev = image
            warps.append(pd.Series(dict(gmc_warp=w), name=image_id))
        return [], warps
