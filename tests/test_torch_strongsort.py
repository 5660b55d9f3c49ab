"""tracklab_torch StrongSORT and its NSA Kalman filter vs the JAX package
and the numpy oracle on the CPU.

The tracker runs in float64 on both sides (tests/conftest.py enables x64),
so ids must match exactly: the streams of tests/test_strongsort.py (two
random seeds, heavy occlusion, empty frames) against JAX's
``strongsort_scan`` and ``tests/oracles/strongsort_oracle.py``, and V = 3
videos over the video axis in both ``batched`` modes against ``jax.vmap``
of the cond-free JAX scan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles.strongsort_oracle import StrongSortOracle
from test_ocsort import assert_frames_equal
from test_strongsort import E_DIM, KW, synth_stream_with_emb
from tracklab_tpu.ops import kalman as JKF
from tracklab_tpu.trackers import strongsort as JS
from tracklab_tpu.trackers.common import Detections as JDet
from tracklab_torch.ops import kalman as TKF
from tracklab_torch.trackers import strongsort as TS
from tracklab_torch.trackers.common import Detections as TDet
from tracklab_torch.trackers.common import pad_detections

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

D, T = 16, 64
STREAMS = {"seed0": dict(seed=0), "seed1": dict(seed=1),
           "heavy_occlusion": dict(seed=5, n_frames=70, n_obj=4, drop=0.3,
                                   fp_rate=0.2)}


def _padded(frames, embs):
    """float64 (F, D, ...) arrays: ltrb, conf, cls, ref, valid, emb."""
    F = len(frames)
    ltrb, conf, cls = np.zeros((F, D, 4)), np.zeros((F, D)), np.zeros((F, D))
    ref, valid = np.full((F, D), -1, np.int32), np.zeros((F, D), bool)
    emb = np.zeros((F, D, E_DIM))
    for f, (r, e) in enumerate(zip(frames, embs)):
        n = min(len(r), D)
        ltrb[f, :n], conf[f, :n], cls[f, :n] = r[:n, :4], r[:n, 4], r[:n, 5]
        ref[f, :n], valid[f, :n], emb[f, :n] = r[:n, 6], True, e[:n]
    return ltrb, conf, cls, ref, valid, emb


def _jax_out(arrays, cfg):
    *d, emb = map(jnp.asarray, arrays)
    scan = jax.jit(lambda dd, e: JS.strongsort_scan(cfg, JDet(*dd), e)[1])
    return type_np(scan(tuple(d), emb))


def type_np(out):
    return type(out)(*(np.asarray(x) for x in out))


def _torch_dets(arrays):
    *d, emb = map(torch.from_numpy, arrays)
    return TDet(*d), emb


def _rows(out, f):
    """One frame's emitted tracks as (box, id, cls, conf, ref) rows."""
    return [(out.ltrb[f, t], int(out.track_id[f, t]), float(out.cls[f, t]),
             float(out.conf[f, t]), int(out.ref[f, t]))
            for t in np.nonzero(out.valid[f])[0]]


def _assert_same(got, want):
    """valid, ids and refs equal; boxes and confs to float64 rounding."""
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    np.testing.assert_array_equal(got.track_id[v], want.track_id[v])
    np.testing.assert_array_equal(got.ref[v], want.ref[v])
    np.testing.assert_allclose(got.ltrb[v], want.ltrb[v], rtol=1e-9,
                               atol=1e-7)
    np.testing.assert_allclose(got.conf[v], want.conf[v], rtol=1e-12)


@pytest.mark.parametrize("stream", list(STREAMS))
def test_scan_matches_jax_and_oracle(stream):
    """Id for id against JAX's strongsort_scan (every output field) and the
    oracle (tests/test_strongsort.py's comparison: boxes within 1e-5)."""
    frames, embs = synth_stream_with_emb(**STREAMS[stream])
    cfg_kw = dict(max_tracks=T, max_dets=D, embed_dim=E_DIM, **KW)
    arrays = _padded(frames, embs)
    want = _jax_out(arrays, JS.StrongSortConfig(**cfg_kw))
    st, out = TS.strongsort_scan(TS.StrongSortConfig(**cfg_kw),
                                 *_torch_dets(arrays))
    got = type_np(out)
    assert want.valid.any() and st.frame.item() == len(frames)
    _assert_same(got, want)
    orc = StrongSortOracle(**KW)
    for f, (r, e) in enumerate(zip(frames, embs)):
        assert_frames_equal(_rows(got, f), orc.update(r, e), f)


def test_empty_frames():
    cfg = TS.StrongSortConfig(max_tracks=8, max_dets=4, embed_dim=E_DIM,
                              **KW)
    dets = pad_detections(np.zeros((0, 4)), np.zeros(0), capacity=4,
                          dtype=torch.float64, device="cpu")
    stacked = TDet(*(torch.stack([x] * 4) for x in dets))
    _, out = TS.strongsort_scan(cfg, stacked,
                                torch.zeros((4, 4, E_DIM),
                                            dtype=torch.float64))
    assert not out.valid.any()


@pytest.fixture(scope="module")
def videos():
    """V = 3 streams of 30 frames, and jax.vmap of the cond-free scan."""
    vids = [_padded(*synth_stream_with_emb(20 + v, n_frames=30))
            for v in range(3)]
    stacked = tuple(np.stack(x) for x in zip(*vids))
    cfg = JS.StrongSortConfig(max_tracks=T, max_dets=D, embed_dim=E_DIM,
                              batched=True, **KW)
    *d, emb = map(jnp.asarray, stacked)
    vm = jax.jit(jax.vmap(lambda dd, e: JS.strongsort_scan(
        cfg, JDet(*dd), e)[1]))
    return stacked, type_np(vm(tuple(d), emb))


@pytest.mark.parametrize("batched", [True, False])
def test_video_axis_matches_jax_vmap(videos, batched):
    stacked, want = videos
    cfg = TS.StrongSortConfig(max_tracks=T, max_dets=D, embed_dim=E_DIM,
                              batched=batched, **KW)
    dets, emb = _torch_dets(stacked)
    st, out = TS.strongsort_scan_videos(cfg, dets, emb)
    assert out.valid.shape == (3, 30, T) and st.next_id.shape == (3,)
    assert want.valid.any()
    _assert_same(type_np(out), want)
    # each video equals its own single-video run
    one = dataclasses.replace(cfg, batched=False)
    _, o1 = TS.strongsort_scan(one, TDet(*(x[2] for x in dets)), emb[2])
    _assert_same(type_np(o1), type(out)(*(np.asarray(x[2]) for x in out)))


def test_nsa_filter_matches_jax():
    """XYAHNSAFilter: initiate, two predicts, gating (full and position
    only) and the confidence-weighted update against JAX in float64."""
    rng = np.random.default_rng(4)
    z = np.column_stack([rng.uniform(100, 500, (6, 2)),
                         rng.uniform(0.3, 0.7, 6), rng.uniform(50, 200, 6)])
    zs = z[::-1] + rng.normal(0, 3, (6, 4))
    conf = rng.uniform(0.2, 1.0, 6)
    JF, TF = JKF.XYAHNSAFilter, TKF.XYAHNSAFilter

    @jax.jit
    def jax_filter(z, zs, conf):
        m, c = jax.vmap(JF.initiate)(z)
        for _ in range(2):
            m, c = JF.predict_batch(m, c)
        gates = [jax.vmap(lambda m_, c_: JF.gating_distance(
            m_, c_, zs, op))(m, c) for op in (False, True)]
        return m, c, gates, jax.vmap(JF.update)(m, c, zs, conf)

    jm0, jc, jgates, (jm, ju) = jax_filter(*map(jnp.asarray, (z, zs, conf)))
    tm, tc = TF.initiate(torch.from_numpy(z))
    for _ in range(2):
        tm, tc = TF.predict(tm, tc)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm0), rtol=1e-12)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12)
    for op, want in zip((False, True), jgates):
        got = TF.gating_distance(tm, tc, torch.from_numpy(zs), op)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    tm, tc = TF.update(tm, tc, torch.from_numpy(zs), torch.from_numpy(conf))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-12)
    np.testing.assert_allclose(tc.numpy(), np.asarray(ju), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("batched", [False, True])
def test_modes_part_as_in_jax(batched):
    """A crowded stream (14 objects in 16 slots) where the two modes give
    different tracks in the JAX package: NaN gating costs of free slots
    and padded rows empty the default mode's appearance stage (the one-hot
    column permutation, a reference fault kept for parity), not the
    rectangular batched mode's. The port gives JAX's tracks in each mode,
    id for id."""
    frames, embs = synth_stream_with_emb(2, n_frames=30, n_obj=14, drop=0.1,
                                         fp_rate=0.3)
    arrays = _padded(frames, embs)
    kw = dict(max_tracks=T, max_dets=D, embed_dim=E_DIM, **KW)
    want = {b: _jax_out(arrays, JS.StrongSortConfig(batched=b, **kw))
            for b in (False, True)}
    assert not np.array_equal(want[False].valid, want[True].valid)
    _, out = TS.strongsort_scan(TS.StrongSortConfig(batched=batched, **kw),
                                *_torch_dets(arrays))
    _assert_same(type_np(out), want[batched])
