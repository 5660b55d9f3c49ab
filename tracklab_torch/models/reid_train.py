"""ReID training in PyTorch (counterpart of tracklab_tpu.models.reid_train):
softmax cross-entropy plus the batch-hard triplet loss on ground-truth crops.

``train_reid`` gathers the crops of a tracking set's split grouped by (video,
track) identity (``_gather_crops``: OpenCV crop and resize on the host), puts
a dense identity head on a fresh OSNet and takes Adam steps on the module's
device, batches drawn from ``np.random.default_rng(seed)``'s permutation of
the crops each epoch (a last short batch is not taken), as the JAX package's
jitted step does. The trained backbone, in ``eval()`` mode, is returned.

As in the JAX package, the starting model is new: it ignores the wrapper's
weights, its ``ibn`` and ``backbone=`` (see ``OSNetReId.train``). flax's
initialisation cannot be drawn in torch, so the start comes from
:func:`initial_model` (seeded); the tests replace it with the JAX package's
initial variables.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

log = logging.getLogger(__name__)

__all__ = ["train_reid", "batch_hard_triplet_loss", "initial_model",
           "reid_loss", "WithHead"]


def batch_hard_triplet_loss(emb, labels, margin: float = 0.3):
    """Per anchor the hardest positive and negative of the batch in cosine
    distance, ``max(pos - neg + margin, 0)``, averaged over the anchors
    that have both."""
    emb = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True),
                            min=1e-12)
    dist = 1.0 - emb @ emb.T
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(labels), dtype=torch.bool, device=emb.device)
    inf = torch.full_like(dist, float("inf"))
    pos = torch.where(same & ~eye, dist, -inf).amax(dim=1)
    neg = torch.where(~same, dist, inf).amin(dim=1)
    valid = torch.isfinite(pos) & torch.isfinite(neg)
    loss = torch.clamp(pos - neg + margin, min=0.0)
    return (torch.where(valid, loss, torch.zeros_like(loss)).sum()
            / torch.clamp(valid.sum(), min=1))


def _gather_crops(tracking_dataset, crop_hw, max_ids=64, max_per_id=8,
                  split="train"):
    """Ground-truth crops (n, h, w, 3) uint8 RGB and their identity labels
    (n,): the first ``max_per_id`` rows of each of the first ``max_ids``
    (video, track) groups of ``split`` (else the first split); a frame that
    does not load is skipped. A frame is decoded once for the crops of
    the identities that share it (the JAX package decodes it per crop)."""
    import cv2

    from tracklab_torch.utils.cv2 import crop_bbox
    from tracklab_torch.utils.cv2 import cv2_load_image as load
    cv2_load_image = functools.lru_cache(maxsize=32)(load)
    ts = tracking_dataset.sets.get(split) or next(
        iter(tracking_dataset.sets.values()))
    dets = ts.detections_gt
    empty = (np.zeros((0,) + tuple(crop_hw) + (3,), np.uint8),
             np.zeros(0, int))
    if dets is None or len(dets) == 0:
        return empty
    crops, labels = [], []
    for label, (_, group) in enumerate(dets.groupby(["video_id",
                                                     "track_id"])):
        if label >= max_ids:
            break
        for _, det in group.head(max_per_id).iterrows():
            meta = ts.image_metadatas.loc[det["image_id"]]
            try:
                img = cv2_load_image(meta["file_path"])
            except Exception:  # an unreadable frame is left out, as in JAX
                continue
            crop = crop_bbox(img, det["bbox_ltwh"])
            crops.append(cv2.resize(crop, (crop_hw[1], crop_hw[0])))
            labels.append(label)
    if not crops:
        return empty
    return np.stack(crops), np.asarray(labels)


class WithHead(nn.Module):
    """A ReID model and a dense identity classifier on one of its outputs
    (``out[key]``); ``forward`` returns ``(model output, logits)``. The
    head is drawn from a ``torch.Generator`` seeded with ``seed``: normal
    with std 1/sqrt(fan_in) (flax's lecun-normal scale), zero bias."""

    def __init__(self, model, feat_dim, n_classes, key="embeddings",
                 seed: int = 0):
        super().__init__()
        self.model = model
        self.head = nn.Linear(feat_dim, n_classes,
                              device=next(model.parameters()).device)
        self.key = key
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.head.weight.copy_(torch.randn(self.head.weight.shape,
                                               generator=g) / feat_dim ** 0.5)
            self.head.bias.zero_()

    def forward(self, *inputs):
        out = self.model(*inputs)
        return out, self.head(out[self.key])


def initial_model(module, n_ids: int, seed: int = 0) -> WithHead:
    """The model ``train_reid`` starts from, on the CPU: OSNet of the
    module's variant, feat_dim and n_parts with ``randomize_(seed)``, and a
    seeded identity head."""
    from tracklab_torch.models.osnet import OSNet

    backbone = OSNet(module.variant, module.feat_dim, module.n_parts,
                     device="cpu").randomize_(seed)
    return WithHead(backbone, module.feat_dim, n_ids, seed=seed)


def fit(model, loss_fn, crops, labels, epochs, batch_size, lr, seed, device,
        what):
    """Adam (optax.adam's defaults) over ``model``'s parameters in
    ``train()`` mode; each epoch a fresh permutation from
    ``np.random.default_rng(seed)``, full batches only. ``loss_fn(model,
    images (B, h, w, 3) uint8 on the device, labels)`` -> scalar. Returns
    the last step's loss of each epoch."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    crops_t = torch.from_numpy(crops)
    labels_t = torch.from_numpy(labels).long()
    rng = np.random.default_rng(seed)
    n = len(crops)
    bsz = min(batch_size, n)
    losses = []
    model.train()
    try:
        for epoch in range(epochs):
            order = torch.from_numpy(rng.permutation(n))
            loss = torch.zeros(())
            for i in range(0, n - bsz + 1, bsz):
                idx = order[i:i + bsz]
                loss = loss_fn(model, crops_t[idx].to(device),
                               labels_t[idx].to(device))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
            losses.append(float(loss.detach()))
            log.info("%s epoch %d: loss %.4f", what, epoch, losses[-1])
    finally:
        model.eval()
    return losses


def normalised(images):
    """uint8 RGB crops -> f32, ImageNet mean and std removed (0-255)."""
    from tracklab_torch.models.preprocess import IMAGENET_MEAN, IMAGENET_STD
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() - mean) / std


def reid_loss(model, images, labels, triplet_weight: float = 1.0):
    """``train_reid``'s loss: a ``WithHead`` OSNet on uint8 crops (B, h, w,
    3) -> cross-entropy of the identity logits plus ``triplet_weight``
    times the batch-hard triplet loss of the embeddings."""
    out, logits = model(normalised(images))
    return (F.cross_entropy(logits, labels)
            + triplet_weight * batch_hard_triplet_loss(out["embeddings"],
                                                       labels))


def train_reid(module, tracking_dataset, epochs: int = 5,
               batch_size: int = 32, lr: float = 3e-4,
               triplet_weight: float = 1.0, seed: int = 0,
               split: str = "train"):
    """Train a new OSNet of the module's shape on the set's ground-truth
    crops; returns ``(trained OSNet on module.device in eval() mode,
    {"loss": [the last step's loss of each epoch]})``, or ``(None, {})``
    when the split has no crop."""
    crop_hw = (module.crop_h, module.crop_w)
    crops, labels = _gather_crops(tracking_dataset, crop_hw, split=split)
    if len(crops) == 0:
        log.warning("train_reid: no GT crops available — skipping")
        return None, {}
    n_ids = int(labels.max()) + 1
    log.info("train_reid: %d crops / %d identities", len(crops), n_ids)
    dev = module.device
    model = initial_model(module, n_ids, seed).to(dev)
    losses = fit(model, functools.partial(reid_loss,
                                          triplet_weight=triplet_weight),
                 crops, labels, epochs, batch_size, lr, seed, dev,
                 "train_reid")
    return model.model, {"loss": losses}
