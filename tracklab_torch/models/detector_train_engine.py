"""Detector fine-tuning on a tracking set's ground truth (counterpart of
tracklab_tpu.models.detector_train_engine).

The detector wrappers' ``train()`` runs this loop on the wrapper's device:
ground truth boxes of a split, each image letterboxed on the host (cv2,
centred, 114 fill), the family's loss and AdamW steps on ``module._model``,
which then stays the trained model. As in the JAX package the family comes
from the module: its ``detection_loss_fn`` where it has one (YOLOv8/YOLO11:
``models/yolov8_train.py``, RT-DETR: ``models/rtdetr_train.py``), else
YOLOX's SimOTA ``detection_loss`` (``models/train.py``); its ``_preproc``
(the input scale); the class count from the model's ``num_classes`` or
``num_labels``.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["train_detector"]


def _gather_batches(tracking_dataset, input_hw, max_images, split):
    """Up to ``max_images`` letterboxed images of ``split`` (else the first
    split) and their boxes, (n, 5) [cx, cy, w, h, category_id - 1] in
    input pixels; an image that does not load is skipped."""
    import cv2

    from tracklab_torch.utils.cv2 import cv2_load_image
    ts = tracking_dataset.sets.get(split) or next(
        iter(tracking_dataset.sets.values()))
    dets = ts.detections_gt
    images, boxes_all = [], []
    th, tw = input_hw
    by_image = dets.groupby("image_id") if len(dets) else None
    for image_id, meta in ts.image_metadatas.iterrows():
        if len(images) >= max_images:
            break
        try:
            img = cv2_load_image(meta["file_path"])
        except Exception:  # an unreadable image is left out, as in JAX
            continue
        h0, w0 = img.shape[:2]
        scale = min(th / h0, tw / w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        canvas = np.full((th, tw, 3), 114, np.uint8)
        top, left = (th - nh) // 2, (tw - nw) // 2
        canvas[top:top + nh, left:left + nw] = cv2.resize(img, (nw, nh))
        gt = []
        if by_image is not None and image_id in by_image.groups:
            for _, det in by_image.get_group(image_id).iterrows():
                l, t, w, h = np.asarray(det["bbox_ltwh"], float)
                gt.append([(l + w / 2) * scale + left,
                           (t + h / 2) * scale + top,
                           w * scale, h * scale,
                           float(det.get("category_id", 1)) - 1])
        images.append(canvas)
        boxes_all.append(np.asarray(gt, np.float32).reshape(-1, 5))
    return images, boxes_all


def train_detector(module, tracking_dataset, epochs: int = 3,
                   batch_size: int = 4, lr: float = 1e-4,
                   max_images: int = 256, max_gt: int = 64,
                   split: str = "train", seed: int = 0):
    """Fine-tune ``module._model`` in place on ``module.device``; returns
    ``{"loss": [the last step's loss of each epoch]}`` (``{}`` without
    images). ``optax.adamw(lr)`` is ``AdamW(lr, weight_decay=1e-4)`` over
    every parameter; batches follow ``np.random.default_rng(seed)``'s
    permutation of the images each epoch, and a last short batch is not
    taken. The module rebuilds its detect closure at its next ``process``."""
    from tracklab_torch.models.train import (create_train_state,
                                             make_train_step)

    if module._model is None:
        module._build()
    h, w = module.input_size
    images, boxes_all = _gather_batches(tracking_dataset, (h, w),
                                        max_images, split)
    if not images:
        log.warning("train_detector: no training images found")
        return {}
    n = len(images)
    log.info("train_detector: %d images", n)
    gt_boxes = np.zeros((n, max_gt, 5), np.float32)
    gt_valid = np.zeros((n, max_gt), bool)
    for i, gt in enumerate(boxes_all):
        k = min(len(gt), max_gt)
        gt_boxes[i, :k] = gt[:k]
        gt_valid[i, :k] = True
    dev = module.device
    images = torch.from_numpy(np.stack(images))
    gt_boxes, gt_valid = torch.from_numpy(gt_boxes), torch.from_numpy(gt_valid)

    state = create_train_state(module._model, functools.partial(
        torch.optim.AdamW, lr=lr, weight_decay=1e-4))
    step = make_train_step((h, w),
                           getattr(module, "detection_loss_fn", None),
                           getattr(module, "_preproc", None))
    rng = np.random.default_rng(seed)
    bsz = min(batch_size, n)
    losses = []
    try:
        for epoch in range(epochs):
            order = torch.from_numpy(rng.permutation(n))
            for i in range(0, n - bsz + 1, bsz):
                idx = order[i:i + bsz]
                state, loss = step(state, {
                    "images": images[idx].to(dev),
                    "gt_boxes": gt_boxes[idx].to(dev),
                    "gt_valid": gt_valid[idx].to(dev)})
            losses.append(float(loss))
            log.info("train_detector epoch %d: loss %.4f", epoch, losses[-1])
    finally:
        module._model.eval()
        module._detect = None
    return {"loss": losses}
