"""tracklab_torch BoT-SORT, its xywh Kalman filter and the box helpers it
brings vs the JAX package and the numpy oracle on the CPU.

The tracker runs in float64 on both sides, so ids must match exactly and
boxes to float64 rounding (rtol 1e-9, atol 1e-7): one video without camera
warps, one with warps, and the same with two empty frames, against JAX's
``botsort_scan`` (one compiled program for all three) and
``tests/oracles/botsort_oracle.py`` (which takes no empty frame); V = 3
videos over the video axis in both ``batched`` modes against ``jax.vmap``
of the JAX scan in that mode. The JAX runs are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles.botsort_oracle import BotSortOracle
from test_botsort import KW
from test_ocsort import assert_frames_equal
from test_strongsort import E_DIM, synth_stream_with_emb
from test_torch_deepocsort import (camera_warps, identity_warps, jax_outputs,
                                   padded, to_torch)
from test_torch_strongsort import _assert_same, _rows, type_np
from tracklab_tpu.ops import boxes as JB
from tracklab_tpu.ops import kalman as JKF
from tracklab_tpu.trackers import botsort as JS
from tracklab_torch.ops import boxes as TB
from tracklab_torch.ops import kalman as TKF
from tracklab_torch.trackers import botsort as TS
from tracklab_torch.trackers.common import Detections as TDet

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

T, D, F = 32, 16, 40
V, FV = 3, 30
STREAMS = ["plain", "warps", "warps_empty"]


@pytest.fixture(scope="module")
def single():
    cfg_kw = dict(max_tracks=T, max_dets=D, embed_dim=E_DIM, **KW)
    frames, embs = synth_stream_with_emb(2, n_frames=F, drop=0.2)
    warps = camera_warps(2, F, shift=1.5)
    e_frames, e_embs = list(frames), list(embs)
    for f in (20, 21):
        e_frames[f], e_embs[f] = np.zeros((0, 7)), np.zeros((0, E_DIM))
    streams = {"plain": (*synth_stream_with_emb(0, n_frames=F), None),
               "warps": (frames, embs, warps),
               "warps_empty": (e_frames, e_embs, warps)}
    batch = {k: (padded(fr, em), identity_warps((F,)) if w is None else w)
             for k, (fr, em, w) in streams.items()}
    return cfg_kw, streams, batch, jax_outputs(
        JS.botsort_scan, JS.BotSortConfig(**cfg_kw), batch)


@pytest.mark.parametrize("name", STREAMS)
def test_scan_matches_jax_and_oracle(single, name):
    """Id for id against JAX's botsort_scan (every output field) and the
    oracle (boxes within 1e-5), or, with empty frames, that they emit
    nothing."""
    cfg_kw, streams, batch, want = single
    frames, embs, warps = streams[name]
    st, out = TS.botsort_scan(TS.BotSortConfig(**cfg_kw),
                              *to_torch(batch[name][0], warps))
    got = type_np(out)
    assert want[name].valid.any() and st.frame_count.item() == F
    _assert_same(got, want[name])
    if name.endswith("empty"):
        assert not got.valid[20:22].any()
        return
    orc = BotSortOracle(**KW)
    for f, (r, e) in enumerate(zip(frames, embs)):
        w = None if warps is None else warps[f]
        assert_frames_equal(_rows(got, f), orc.update(r, e, w), f)


@pytest.fixture(scope="module")
def videos():
    """V streams with warps, and jax.vmap of the JAX scan in each mode."""
    vids = [synth_stream_with_emb(50 + v, n_frames=FV, drop=0.25)
            for v in range(V)]
    arrays = tuple(np.stack(x) for x in zip(*(padded(*s) for s in vids)))
    warps = np.stack([camera_warps(60 + v, FV, shift=1.5)
                      for v in range(V)])
    cfg_kw = dict(max_tracks=T, max_dets=D, embed_dim=E_DIM, **KW)
    want = {b: jax_outputs(JS.botsort_scan,
                           JS.BotSortConfig(batched=b, **cfg_kw),
                           {"v": (arrays, warps)}, vmap=True)["v"]
            for b in (False, True)}
    return cfg_kw, arrays, warps, want


@pytest.mark.parametrize("batched", [False, True])
def test_video_axis_matches_jax_vmap(videos, batched):
    cfg_kw, arrays, warps, want = videos
    cfg = TS.BotSortConfig(batched=batched, **cfg_kw)
    dets, emb, w = to_torch(arrays, warps)
    st, out = TS.botsort_scan_videos(cfg, dets, emb, w)
    assert out.valid.shape == (V, FV, T) and st.next_id.shape == (V,)
    assert want[batched].valid.any()
    _assert_same(type_np(out), want[batched])
    _, o1 = TS.botsort_scan(cfg, TDet(*(x[1] for x in dets)), emb[1], w[1])
    _assert_same(type_np(o1), type(out)(*(np.asarray(x[1]) for x in out)))


def test_xywh_filter_matches_jax():
    """XYWHFilter: initiate, two predicts, gating (full and position only)
    and update against JAX in float64, within rtol 1e-6 / atol 1e-6."""
    rng = np.random.default_rng(5)
    z = np.column_stack([rng.uniform(100, 500, (6, 2)),
                         rng.uniform(20, 200, (6, 2))])
    zs = z[::-1] + rng.normal(0, 3, (6, 4))
    JF, TF = JKF.XYWHFilter, TKF.XYWHFilter

    @jax.jit
    def jax_filter(z, zs):
        m, c = jax.vmap(JF.initiate)(z)
        m0, c0 = m, c
        for _ in range(2):
            m, c = JF.predict_batch(m, c)
        gates = [jax.vmap(lambda m_, c_: JF.gating_distance(
            m_, c_, zs, op))(m, c) for op in (False, True)]
        return (m0, c0), (m, c), gates, JF.update_batch(m, c, zs)

    jinit, jpred, jgates, jupd = jax_filter(jnp.asarray(z), jnp.asarray(zs))
    init = TF.initiate(torch.from_numpy(z))
    pred = init
    for _ in range(2):
        pred = TF.predict(*pred)
    gates = [TF.gating_distance(*pred, torch.from_numpy(zs), op)
             for op in (False, True)]
    upd = TF.update(*pred, torch.from_numpy(zs))
    for got, want in (*zip(init, jinit), *zip(pred, jpred),
                      *zip(gates, jgates), *zip(upd, jupd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


BOX_FUNCS = ["ltwh_to_ltrb", "ltrb_to_xywh", "xyah_to_ltwh",
             "ct_dist_matrix", "ct_dist_matrix_masked"]


@pytest.mark.parametrize("fn", BOX_FUNCS)
def test_box_functions_match_jax(fn):
    """The box helpers of this slice against JAX within 1e-6 (float64)."""
    rng = np.random.default_rng(6)
    a = np.column_stack([rng.uniform(0, 500, (7, 2)),
                         rng.uniform(10, 100, (7, 2))])
    b = np.column_stack([rng.uniform(0, 500, (5, 2)),
                         rng.uniform(10, 100, (5, 2))])
    if fn.startswith("ct_dist"):
        mask = rng.uniform(size=(7, 5)) < 0.6 if fn.endswith("masked") \
            else None
        want = JB.ct_dist_matrix(jnp.asarray(a), jnp.asarray(b),
                                 None if mask is None else jnp.asarray(mask))
        got = TB.ct_dist_matrix(torch.from_numpy(a), torch.from_numpy(b),
                                None if mask is None
                                else torch.from_numpy(mask))
    else:
        want = getattr(JB, fn)(jnp.asarray(a))
        got = getattr(TB, fn)(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_config_matches_jax():
    """The port's config carries the JAX config's fields, defaults and
    max_time_lost."""
    j, t = JS.BotSortConfig(track_buffer=45), TS.BotSortConfig(track_buffer=45)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.max_time_lost == t.max_time_lost == 45
