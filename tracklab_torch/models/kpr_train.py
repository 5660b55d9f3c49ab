"""KPR training in PyTorch (counterpart of tracklab_tpu.models.kpr_train):
identity cross-entropy on the foreground branch plus the part-averaged
batch-hard triplet loss over the per-part embeddings, each part weighted by
its mean visibility.

``train_kpr`` fine-tunes the wrapper's KPR where it has one (else a seeded
new one, as the JAX package draws a new one without variables) with a new
dense identity head on ``bn_foreg``, on the ground-truth crops of
``reid_train._gather_crops``, with zero keypoint prompts, Adam and the JAX
package's batch order. Every attention of the ViT runs through K4's autograd
Function on the card (``kernels/vit_attention.py:VitAttentionFn``).
"""
from __future__ import annotations

import functools
import logging

import torch
import torch.nn.functional as F

from tracklab_torch.models.reid_train import (WithHead, _gather_crops,
                                              batch_hard_triplet_loss, fit,
                                              normalised)

log = logging.getLogger(__name__)

__all__ = ["train_kpr", "part_averaged_triplet_loss", "initial_model",
           "kpr_loss"]


def part_averaged_triplet_loss(parts, vis, labels, margin: float = 0.3):
    """The mean over parts of the batch-hard triplet loss of each part's
    embeddings (B, K, D), each weighted by the part's mean visibility (B,
    K)."""
    losses = [batch_hard_triplet_loss(parts[:, k], labels, margin)
              * vis[:, k].mean() for k in range(parts.shape[1])]
    return torch.stack(losses).mean()


def kpr_loss(model, images, labels, n_prompt_ch: int, ce_weight: float = 1.0,
             triplet_weight: float = 1.0):
    """``train_kpr``'s loss: a ``WithHead`` KPR on uint8 crops (B, h, w, 3)
    with zero prompts -> ``ce_weight`` times the cross-entropy of the
    identity logits plus ``triplet_weight`` times the part-averaged
    triplet loss."""
    prompts = torch.zeros(images.shape[:3] + (n_prompt_ch,),
                          device=images.device)
    out, logits = model(normalised(images), prompts)
    tri = part_averaged_triplet_loss(out["parts"],
                                     out["visibility"]["parts"], labels)
    return ce_weight * F.cross_entropy(logits, labels) + triplet_weight * tri


def initial_model(module, n_ids: int, seed: int = 0) -> WithHead:
    """The model ``train_kpr`` starts from, on ``module.device``: the
    module's KPR (trained in place) when it has one (built, or left by an
    earlier ``train``), else a new one of its ``arch`` with
    ``randomize_(seed)``; and a seeded identity head on ``bn_foreg``."""
    from tracklab_torch.models.kpr import KPR

    model = module._model if module._model is not None else module._trained
    if model is None:
        model = KPR(n_prompt_ch=module.n_prompt_ch, device="cpu",
                    **module.arch).randomize_(seed).to(module.device)
    return WithHead(model, module.arch["dim_reduce_output"], n_ids,
                    key="bn_foreg", seed=seed)


def train_kpr(module, tracking_dataset, epochs: int = 3,
              batch_size: int = 16, lr: float = 1e-4, seed: int = 0,
              split: str = "train", ce_weight: float = 1.0,
              triplet_weight: float = 1.0):
    """Fine-tune on the set's ground-truth crops; returns ``(trained KPR on
    module.device in eval() mode, {"loss": [the last step's loss of each
    epoch]})``, or ``(None, {})`` when the split has no crop."""
    crop_hw = (module.crop_h, module.crop_w)
    crops, labels = _gather_crops(tracking_dataset, crop_hw, split=split)
    if len(crops) == 0:
        log.warning("train_kpr: no GT crops available — skipping")
        return None, {}
    n_ids = int(labels.max()) + 1
    log.info("train_kpr: %d crops / %d identities", len(crops), n_ids)
    dev = module.device
    model = initial_model(module, n_ids, seed).to(dev)
    loss_fn = functools.partial(kpr_loss, n_prompt_ch=module.n_prompt_ch,
                                ce_weight=ce_weight,
                                triplet_weight=triplet_weight)
    losses = fit(model, loss_fn, crops, labels, epochs, batch_size, lr, seed,
                 dev, "train_kpr")
    return model.model, {"loss": losses}
