"""GS-HOTA: game-state HOTA on pitch coordinates with attribute identity
(counterpart of tracklab_tpu.eval.gs_metrics, kept as the port's own copy).

The similarity between a prediction and a ground-truth object is

    Sim = LocSim * IdSim
    LocSim = exp(-d^2 / (2 * tol^2))   d = pitch-plane distance (meters)
    IdSim  = 1 iff all enabled attributes (role / team / jersey) match

plugged into the standard HOTA machinery (the metric stack is
similarity-agnostic).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from tracklab_torch.eval.metrics import SequenceData

__all__ = ["make_gs_sequence_data", "gs_similarity"]


def gs_similarity(gt_pos, gt_attrs, pred_pos, pred_attrs,
                  dist_tol: float = 5.0,
                  use_roles=True, use_teams=True, use_jerseys=True):
    """(G, 2) x (P, 2) pitch positions + attribute dicts -> (G, P)."""
    if len(gt_pos) == 0 or len(pred_pos) == 0:
        return np.zeros((len(gt_pos), len(pred_pos)))
    d2 = ((gt_pos[:, None, 0] - pred_pos[None, :, 0]) ** 2
          + (gt_pos[:, None, 1] - pred_pos[None, :, 1]) ** 2)
    loc = np.exp(-d2 / (2 * dist_tol ** 2))

    def match(key, enabled):
        if not enabled:
            return np.ones((len(gt_pos), len(pred_pos)), bool)
        g = np.array([a.get(key) for a in gt_attrs], object)
        p = np.array([a.get(key) for a in pred_attrs], object)
        eq = np.empty((len(g), len(p)), bool)
        for i, gv in enumerate(g):
            for j, pv in enumerate(p):
                eq[i, j] = (gv == pv) or (gv is None and pv is None)
        return eq

    ids = (match("role", use_roles) & match("team", use_teams)
           & match("jersey", use_jerseys))
    return loc * ids


def make_gs_sequence_data(gt_frames: Dict[int, tuple],
                          pred_frames: Dict[int, tuple],
                          dist_tol: float = 5.0,
                          use_roles=True, use_teams=True,
                          use_jerseys=True) -> SequenceData:
    """Frames map to (ids, positions (N, 2), attrs list-of-dicts)."""
    frames = sorted(set(gt_frames) | set(pred_frames))
    gmap, pmap = {}, {}
    gt_ids, pred_ids, sims = [], [], []
    n_gt = n_pred = 0
    empty = (np.zeros(0, int), np.zeros((0, 2)), [])
    for f in frames:
        gids, gpos, gattr = gt_frames.get(f, empty)
        pids, ppos, pattr = pred_frames.get(f, empty)
        for i in gids:
            gmap.setdefault(i, len(gmap))
        for i in pids:
            pmap.setdefault(i, len(pmap))
        gt_ids.append(np.array([gmap[i] for i in gids], int))
        pred_ids.append(np.array([pmap[i] for i in pids], int))
        sims.append(gs_similarity(np.asarray(gpos), gattr,
                                  np.asarray(ppos), pattr, dist_tol,
                                  use_roles, use_teams, use_jerseys))
        n_gt += len(gids)
        n_pred += len(pids)
    return SequenceData(len(gmap), len(pmap), n_gt, n_pred, gt_ids,
                        pred_ids, sims)
