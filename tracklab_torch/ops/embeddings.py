"""Appearance embeddings for StrongSORT (counterpart of
tracklab_tpu.ops.embeddings): cosine distances, the EMA feature bank and
per-track sample galleries as fixed-capacity ring buffers.

The reference's NearestNeighborDistanceMetric (nn_matching.py:30-162) keeps
a Python list of samples per track; here each track's gallery is a (B, E)
ring in a (..., T, B, E) tensor and the min-over-gallery cosine distance is
one batched product. Every function takes any leading (video) dims and
issues no host sync.
"""
from __future__ import annotations

import torch

__all__ = ["normalize_rows", "cosine_distance_matrix", "nn_gallery_distance",
           "ema_update", "gallery_push"]


def normalize_rows(x, eps: float = 1e-12):
    """x / max(||x||, eps) over the last axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def cosine_distance_matrix(a, b, normalized: bool = False):
    """(..., N, E) x (..., M, E) -> (..., N, M) cosine distance (1 - cos)."""
    if not normalized:
        a, b = normalize_rows(a), normalize_rows(b)
    return 1.0 - a @ b.transpose(-1, -2)


def nn_gallery_distance(gallery, gallery_valid, feats,
                        normalized: bool = True):
    """Min cosine distance from each track's gallery to each query feature
    (nn_matching.py:73-91 _nn_cosine_distance): gallery (..., T, B, E),
    gallery_valid (..., T, B) bool, feats (..., D, E) -> (..., T, D); a
    track with an empty gallery gives 1e5."""
    if not normalized:
        gallery, feats = normalize_rows(gallery), normalize_rows(feats)
    sim = torch.einsum("...tbe,...de->...tbd", gallery, feats)
    dist = torch.where(gallery_valid[..., None], 1.0 - sim,
                       torch.full_like(sim, float("inf")))
    out = dist.amin(dim=-2)
    return torch.where(torch.isfinite(out), out, torch.full_like(out, 1e5))


def ema_update(feat, new_feat, alpha, apply):
    """StrongSORT's feature EMA (track.py:286-288): the new feature
    normalised, blended, renormalised; ``apply`` (..., T) bool picks the
    tracks to update."""
    smooth = alpha * feat + (1.0 - alpha) * normalize_rows(new_feat)
    return torch.where(apply[..., None], normalize_rows(smooth), feat)


def gallery_push(gallery, gallery_valid, write_pos, feats, push):
    """Append ``feats`` (..., T, E) to the per-track rings where ``push``
    (..., T) is set: gallery (..., T, B, E), gallery_valid (..., T, B),
    write_pos (..., T) int32. Returns the updated (gallery, gallery_valid,
    write_pos); the inputs are not modified."""
    B = gallery.shape[-2]
    pos = torch.remainder(write_pos, B).long()
    at = (torch.arange(B, device=pos.device) == pos[..., None]) \
        & push[..., None]                                     # (..., T, B)
    gallery = torch.where(at[..., None], feats[..., None, :], gallery)
    gallery_valid = gallery_valid | at
    write_pos = torch.where(push, write_pos + 1, write_pos)
    return gallery, gallery_valid, write_pos
