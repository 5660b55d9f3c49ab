"""KPR part-based ReID modules (counterpart of
tracklab_tpu.wrappers.reid.kpr_api): ``models/kpr.py``'s promptable ViT
with the BPBReID part head, on the card.

``KPReId`` is a DetectionLevelModule: the loader threads cut each
detection's box out of its frame (:func:`crop_bbox`), resize it to the crop
size with OpenCV's bilinear resize and, with ``use_keypoints``, draw its
keypoint prompts: the row's ``keypoints_xyc`` grouped by the cck6 scheme
into 6 gaussian channels (the max over a group's keypoints of confidence
>= ``vis_thresh``) and a 7th channel from the row's ``negative_kps`` (other
people's keypoints), all through ``reid_dataset.py:gaussian_keypoint_masks``;
without keypoints the prompts are zero. The card normalises a batch of
crops and runs KPR; ``extract_test_embeddings`` stacks the configured
branches (default ``bn_foreg`` and ``parts``) into ``embeddings`` (1 + K, D)
and ``visibility_scores`` (1 + K) per detection, the columns the
BPBReID-StrongSORT tracker reads.

``KPReIdBatched`` is an ImageLevelModule: the loader threads resize each
frame to the work size and pad its boxes (and, with ``use_keypoints``, its
keypoints, both in work coordinates) to ``max_dets`` slots; the card crops
every slot (``models/preprocess.py:crop_resize``), draws the prompts
(``models/kpr.py:gaussian_prompt_maps``; the maps are crop-relative, so
work coordinates give the maps of the original ones) and runs KPR over the
batch (``engine/fused.py:make_kpr_embed_fn``).

The engine's fused path runs either module inside one device program:
promptless between a fused detector and the part-based tracker
(``engine/fused.py:run_fused_parts_video``), or prompted from a fused
top-down pose module (``run_fused_gsr_video``). Its crops then come from
the detector's letterboxed frames and its prompts from the device
rasterizer, which are ``KPReIdBatched``'s when its work size equals the
detector's input and the frame size.

Weights: ``checkpoint_path`` names a ``torch.save``d state dict, either the
port's (``models/convert.py:kpr_from_flax`` builds one from the JAX
package's tree) or a reference KPR checkpoint (loaded through
``convert_kpr_torch``); without one the weights are seeded random
(``KPR.randomize_(0)``).
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.models.preprocess import IMAGENET_MEAN, IMAGENET_STD
from tracklab_torch.pipeline.levels import (DetectionLevelModule,
                                            ImageLevelModule)
from tracklab_torch.utils.collate import default_collate

log = logging.getLogger(__name__)

__all__ = ["KPReId", "KPReIdBatched", "build_kpr"]

_NOT_PORTED = "{} is not ported to tracklab_torch yet (ROADMAP item {})"


def build_kpr(owner: str, arch: dict, n_prompt_ch: int, checkpoint_path,
              device):
    """A ``models.kpr.KPR`` of ``arch`` on ``device`` with the weights of
    ``checkpoint_path`` (the port's state dict, loaded strict, or a
    reference KPR state dict through ``convert_kpr_torch``), else seeded
    random weights."""
    from tracklab_torch.models.convert import convert_kpr_torch
    from tracklab_torch.models.kpr import KPR

    model = KPR(n_prompt_ch=n_prompt_ch, device="cpu", **arch)
    model.randomize_(0)
    if checkpoint_path:
        state = torch.load(checkpoint_path, map_location="cpu",
                           weights_only=True)
        state = state.get("state_dict", state)
        if set(state) == set(model.state_dict()):
            model.load_state_dict(state, strict=True)
        else:
            convert_kpr_torch(state, model)
    else:
        log.warning("%s: no checkpoint_path given — running with random "
                    "weights", owner)
    return model.to(resolve_device(device))


class _KPRModule:
    """What both KPR modules share: the architecture, the model, the
    device embed function, the fused-path flags and the output rows."""

    output_columns = ["embeddings", "visibility_scores"]
    training_enabled = True
    collate_fn = staticmethod(default_collate)

    def __init__(self, crop_size=(384, 128), batch_size: int = 32,
                 num_parts: int = 5, dim_reduce_output: int = 512,
                 embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 stride: int = 16,
                 test_embeddings=("bn_foreg", "parts"),
                 binary_visibility: bool = True,
                 use_keypoints: bool = True, vis_thresh: float = 0.3,
                 checkpoint_path: str | None = None, device=None,
                 embed_buckets=None, **kwargs):
        super().__init__(batch_size)
        self.crop_h, self.crop_w = crop_size
        self.num_parts = num_parts
        self.arch = dict(
            num_parts=num_parts, dim_reduce_output=dim_reduce_output,
            img_size=tuple(crop_size), patch_size=patch_size, stride=stride,
            embed_dim=embed_dim, depth=depth, num_heads=num_heads)
        self.test_embeddings = tuple(test_embeddings)
        self.binary_visibility = binary_visibility
        self.use_keypoints = use_keypoints
        self.vis_thresh = vis_thresh
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        # live-prefix widths for the fused path (engine/fused.py:
        # _bucketed_embed, one host read per chunk); None embeds every slot
        self.embed_buckets = (tuple(embed_buckets) if embed_buckets
                              else None)
        self._model = None
        self._consts = None
        self.input_columns = ["bbox_ltwh"] + (
            ["keypoints_xyc"] if use_keypoints else [])

    @property
    def n_prompt_ch(self):
        """The cck6 groups and the negative-keypoint channel."""
        from tracklab_torch.models.kpr import PROMPT_GROUPS_CCK6
        return len(PROMPT_GROUPS_CCK6) + 1

    @property
    def supports_fused_parts(self):
        # between a fused detector and the part-based tracker
        # (engine/fused.py:run_fused_parts_video): promptless only, as no
        # pose module runs inside that program to prompt it
        return not self.use_keypoints

    @property
    def supports_fused_prompted_parts(self):
        # after a fused top-down pose module (engine/fused.py:
        # run_fused_gsr_video), its prompts drawn on the device
        return self.use_keypoints

    def _build(self):
        self._model = build_kpr(type(self).__name__, self.arch,
                                self.n_prompt_ch, self.checkpoint_path,
                                self.device)
        self._consts = tuple(torch.tensor(c, dtype=torch.float32,
                                          device=self.device)
                             for c in (IMAGENET_MEAN, IMAGENET_STD))

    def device_embed_fn(self):
        """``(frames, boxes, keypoints=None) -> dict`` on the card: device
        crops, prompts drawn on the device from ``keypoints`` (zero without
        them) and KPR, the same math as ``KPReIdBatched.process`` (for the
        fused path the frames are the detector's)."""
        from tracklab_torch.engine.fused import make_kpr_embed_fn
        if self._model is None:
            self._build()
        return make_kpr_embed_fn(
            self._model, crop_size=(self.crop_h, self.crop_w),
            n_prompt_ch=self.n_prompt_ch,
            test_embeddings=self.test_embeddings,
            binary_visibility=self.binary_visibility,
            vis_thresh=self.vis_thresh)

    @staticmethod
    def _rows(out, rows, slots):
        """The output rows of the embedded ``slots`` (frame and slot index
        arrays into ``out``'s leading (frames, slots) axes), indexed by
        ``rows[slots]``: the part layout and its visibility."""
        result = pd.DataFrame(index=rows[slots])
        result["embeddings"] = list(out["embeddings"].cpu().numpy()[slots])
        result["visibility_scores"] = list(
            out["visibility"].cpu().numpy()[slots])
        return result

    def train(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(
            f"{type(self).__name__}.train", "6: training"))


class KPReId(_KPRModule, DetectionLevelModule):

    def preprocess(self, image, detection: pd.Series, metadata: pd.Series):
        """Host thread: the detection's crop, resized with OpenCV, and its
        prompt maps (zero without ``use_keypoints``)."""
        import cv2

        from tracklab_torch.utils.cv2 import crop_bbox
        crop = crop_bbox(image, detection["bbox_ltwh"])
        crop = cv2.resize(crop, (self.crop_w, self.crop_h),
                          interpolation=cv2.INTER_LINEAR).astype(np.float32)
        if self.use_keypoints:
            prompts = self._prompt_masks(detection)
        else:
            prompts = np.zeros((self.crop_h, self.crop_w, self.n_prompt_ch),
                               np.float32)
        return {"crop": crop, "prompts": prompts}

    def _prompt_masks(self, detection):
        """Positive keypoints -> the cck6 gaussian channels (keypoints of
        confidence >= ``vis_thresh``); ``negative_kps`` -> the last
        channel."""
        from tracklab_torch.models.kpr import PROMPT_GROUPS_CCK6
        from tracklab_torch.wrappers.reid.reid_dataset import \
            gaussian_keypoint_masks
        G = len(PROMPT_GROUPS_CCK6)
        prompts = np.zeros((self.crop_h, self.crop_w, G + 1), np.float32)
        kp = detection.get("keypoints_xyc")
        if isinstance(kp, np.ndarray) and len(kp):
            masks = gaussian_keypoint_masks(
                kp, (self.crop_h, self.crop_w), detection["bbox_ltwh"])
            conf_ok = kp[:, 2] >= self.vis_thresh
            for g, idxs in enumerate(PROMPT_GROUPS_CCK6):
                idxs = [i for i in idxs if i < len(kp) and conf_ok[i]]
                if idxs:
                    prompts[..., g] = masks[idxs].max(axis=0)
        neg = detection.get("negative_kps")
        if isinstance(neg, np.ndarray) and len(neg):
            prompts[..., G] = gaussian_keypoint_masks(
                neg, (self.crop_h, self.crop_w),
                detection["bbox_ltwh"]).max(axis=0)
        return prompts

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        from tracklab_torch.models.kpr import extract_test_embeddings
        if self._model is None:
            self._build()
        mean, std = self._consts
        crops = torch.from_numpy(np.asarray(batch["crop"])).to(self.device)
        prompts = torch.from_numpy(np.asarray(batch["prompts"])).to(
            self.device)
        out = self._model((crops - mean) / std, prompts)
        emb, vis = extract_test_embeddings(out, self.test_embeddings,
                                           self.binary_visibility)
        result = pd.DataFrame(index=detections.index)
        result["embeddings"] = list(emb.float().cpu().numpy())
        result["visibility_scores"] = list(vis.float().cpu().numpy())
        return result


class KPReIdBatched(_KPRModule, ImageLevelModule):

    def __init__(self, *args, work_size=(736, 1280), max_dets: int = 32,
                 n_keypoints: int = 17, **kwargs):
        super().__init__(*args, **kwargs)
        self.work_h, self.work_w = work_size
        self.max_dets = max_dets
        self.n_keypoints = n_keypoints
        self._embed = None

    def preprocess(self, image, detections: pd.DataFrame,
                   metadata: pd.Series):
        """Host thread: the work image and the frame's boxes (and with
        ``use_keypoints`` its keypoints) in work coordinates, padded to
        ``max_dets`` (row id -1 on empty slots)."""
        import cv2
        h0, w0 = image.shape[:2]
        work = cv2.resize(image, (self.work_w, self.work_h))
        sx, sy = self.work_w / w0, self.work_h / h0
        boxes = np.zeros((self.max_dets, 4), np.float32)
        rows = np.full(self.max_dets, -1, np.int64)
        kps = np.zeros((self.max_dets, self.n_keypoints, 3), np.float32)
        n = min(len(detections), self.max_dets)
        if n:
            ltwh = np.stack(detections["bbox_ltwh"].to_numpy()[:n])
            boxes[:n, 0] = ltwh[:, 0] * sx
            boxes[:n, 1] = ltwh[:, 1] * sy
            boxes[:n, 2] = (ltwh[:, 0] + ltwh[:, 2]) * sx
            boxes[:n, 3] = (ltwh[:, 1] + ltwh[:, 3]) * sy
            rows[:n] = detections.index.to_numpy()[:n]
            if self.use_keypoints and "keypoints_xyc" in detections:
                for i, k in enumerate(
                        detections["keypoints_xyc"].to_numpy()[:n]):
                    if isinstance(k, np.ndarray):
                        r = min(len(k), self.n_keypoints)
                        kps[i, :r] = k[:r]
                # into work coordinates with the boxes (the prompt maps
                # are crop-relative, so the pair gives the same maps)
                kps[:, :, 0] *= sx
                kps[:, :, 1] *= sy
        out = {"image": work, "boxes": boxes, "rows": rows}
        if self.use_keypoints:
            out["keypoints"] = kps
        return out

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        if self._embed is None:
            self._embed = self.device_embed_fn()
        # a short last batch is padded to batch_size with empty frames, so
        # every frame goes through one batch shape
        names = ("image", "boxes") + (("keypoints",) if self.use_keypoints
                                      else ())
        arrays = [np.asarray(batch[k]) for k in names]
        n = len(arrays[0])
        if n < self.batch_size:
            arrays = [np.concatenate([a, np.zeros(
                (self.batch_size - n,) + a.shape[1:], a.dtype)])
                for a in arrays]
        out = self._embed(*(torch.from_numpy(a).to(self.device)
                            for a in arrays))
        rows = np.asarray(batch["rows"])
        return self._rows(out, rows, np.nonzero(rows >= 0))
