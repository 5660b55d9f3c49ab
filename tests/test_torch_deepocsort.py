"""tracklab_torch Deep-OC-SORT, its "new KF" and its ORU replay vs the JAX
package and the numpy oracle on the CPU.

The tracker runs in float64 on both sides (tests/conftest.py enables x64),
so ids must match exactly and boxes to float64 rounding (rtol 1e-9, atol
1e-7): one video without camera warps, one with warps and occlusion gaps,
and the same with two empty frames, against JAX's ``deepocsort_scan`` (one
compiled program for all three) and ``tests/oracles/deepocsort_oracle.py``
(which takes no empty frame, so not on the third); V = 3 videos
over the video axis in both ``batched`` modes against ``jax.vmap`` of the
JAX scan in that mode. The JAX runs are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles.deepocsort_oracle import DeepOCSortOracle
from test_deepocsort import KW
from test_ocsort import assert_frames_equal
from test_strongsort import E_DIM, synth_stream_with_emb
from test_torch_strongsort import _assert_same, _rows, type_np
from tracklab_tpu.trackers import deepocsort as JD
from tracklab_tpu.trackers.common import Detections as JDet
from tracklab_torch.kernels.oru_replay import (oru_replay_nkf,
                                               oru_replay_nkf_plain)
from tracklab_torch.trackers import deepocsort as TD
from tracklab_torch.trackers.common import Detections as TDet

T, D, F = 32, 16, 40
V, FV = 3, 30


def padded(frames, embs, capacity=D):
    """float64 (F, D, ...) arrays: ltrb, conf, cls, ref, valid, emb."""
    n_f = len(frames)
    ltrb, conf = np.zeros((n_f, capacity, 4)), np.zeros((n_f, capacity))
    cls = np.zeros((n_f, capacity))
    ref, valid = (np.full((n_f, capacity), -1, np.int32),
                  np.zeros((n_f, capacity), bool))
    emb = np.zeros((n_f, capacity, E_DIM))
    for f, (r, e) in enumerate(zip(frames, embs)):
        n = min(len(r), capacity)
        ltrb[f, :n], conf[f, :n], cls[f, :n] = r[:n, :4], r[:n, 4], r[:n, 5]
        ref[f, :n], valid[f, :n], emb[f, :n] = r[:n, 6], True, e[:n]
    return ltrb, conf, cls, ref, valid, emb


def camera_warps(seed, n, rot=0.002, shift=1.2):
    """n small random rigid warps (2, 3), float64."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.normal(0, rot)
        t = rng.normal(0, shift, 2)
        out.append(np.array([[np.cos(a), -np.sin(a), t[0]],
                             [np.sin(a), np.cos(a), t[1]]]))
    return np.stack(out)


STREAMS = ["plain", "warps_occlusion", "warps_occlusion_empty",
           "stop_while_occluded"]


def stop_while_occluded(seed=7):
    """Four objects; object 0 runs at 14 px per frame, is occluded for
    frames 10-15 and reappears where it vanished: the prediction has run
    ahead while its last observation has not, so OCR matches it."""
    rng = np.random.default_rng(seed)
    start = np.array([[200.0, 300], [700, 300], [400, 700], [1100, 600]])
    vel = np.array([[14.0, 0], [2, 1], [-2, 1], [0, -2]])
    size = np.array([60.0, 120])
    obj_emb = rng.normal(size=(4, E_DIM))
    frames, embs, ref = [], [], 0
    for f in range(F):
        rows, es = [], []
        for k in range(4):
            if k == 0 and 10 <= f <= 15:
                continue
            t = min(f, 9) if k == 0 else f
            c = start[k] + vel[k] * t + rng.normal(0, 1, 2)
            rows.append([*c, *(c + size), rng.uniform(0.5, 1.0), 1.0, ref])
            es.append(obj_emb[k] + rng.normal(0, 0.1, E_DIM))
            ref += 1
        frames.append(np.array(rows))
        embs.append(np.array(es))
    return frames, embs


def single_streams():
    """{name: (frames, embs, warps or None)}: one plain stream; one with
    camera warps and heavy occlusion; the same with frames 12 and 13
    empty; :func:`stop_while_occluded`."""
    plain = synth_stream_with_emb(0, n_frames=F)
    frames, embs = synth_stream_with_emb(4, n_frames=F, drop=0.3)
    warps = camera_warps(4, F)
    e_frames, e_embs = list(frames), list(embs)
    for f in (12, 13):
        e_frames[f], e_embs[f] = np.zeros((0, 7)), np.zeros((0, E_DIM))
    return {"plain": (*plain, None),
            "warps_occlusion": (frames, embs, warps),
            "warps_occlusion_empty": (e_frames, e_embs, warps),
            "stop_while_occluded": (*stop_while_occluded(), None)}


def to_torch(arrays, warps):
    *d, emb = map(torch.from_numpy, arrays)
    return TDet(*d), emb, None if warps is None else torch.from_numpy(warps)


def jax_outputs(scan, cfg, batch, vmap=False):
    """{name: numpy outputs} of ``scan(cfg, dets, emb, warps)`` jitted once
    (vmapped over a leading video axis with ``vmap``) for each entry of
    ``batch``: {name: (arrays, warps)}."""
    fn = lambda d, e, w: scan(cfg, JDet(*d), e, w)[1]  # noqa: E731
    fn = jax.jit(jax.vmap(fn) if vmap else fn)
    out = {}
    for name, (arrays, warps) in batch.items():
        *d, emb = map(jnp.asarray, arrays)
        out[name] = type_np(fn(tuple(d), emb, jnp.asarray(warps)))
    return out


def identity_warps(lead):
    return np.broadcast_to(np.eye(2, 3), tuple(lead) + (2, 3)).copy()


@pytest.fixture(scope="module")
def single():
    cfg_kw = dict(max_tracks=T, max_dets=D, embed_dim=E_DIM, asso_func="iou",
                  **KW)
    streams = single_streams()
    batch = {k: (padded(fr, em), identity_warps((F,)) if w is None else w)
             for k, (fr, em, w) in streams.items()}
    return cfg_kw, streams, batch, jax_outputs(
        JD.deepocsort_scan, JD.DeepOCSortConfig(**cfg_kw), batch)


@pytest.mark.parametrize("name", STREAMS)
def test_scan_matches_jax_and_oracle(single, name):
    """Id for id against JAX's deepocsort_scan (every output field) and the
    oracle (boxes within 1e-5), or, with empty frames, that they emit
    nothing."""
    cfg_kw, streams, batch, want = single
    frames, embs, warps = streams[name]
    st, out = TD.deepocsort_scan(TD.DeepOCSortConfig(**cfg_kw),
                                 *to_torch(batch[name][0], warps))
    got = type_np(out)
    assert want[name].valid.any() and st.frame_count.item() == F
    _assert_same(got, want[name])
    if name.endswith("empty"):
        assert not got.valid[12:14].any()
        return
    orc = DeepOCSortOracle(**KW)
    for f, (r, e) in enumerate(zip(frames, embs)):
        w = None if warps is None else warps[f]
        assert_frames_equal(_rows(got, f), orc.update(r, e, w), f)


@pytest.fixture(scope="module")
def videos():
    """V streams with warps, and jax.vmap of the JAX scan in each mode."""
    vids = [synth_stream_with_emb(30 + v, n_frames=FV, drop=0.25)
            for v in range(V)]
    arrays = tuple(np.stack(x) for x in zip(*(padded(*s) for s in vids)))
    warps = np.stack([camera_warps(40 + v, FV) for v in range(V)])
    cfg_kw = dict(max_tracks=T, max_dets=D, embed_dim=E_DIM,
                  asso_func="giou", **KW)
    want = {b: jax_outputs(JD.deepocsort_scan,
                           JD.DeepOCSortConfig(batched=b, **cfg_kw),
                           {"v": (arrays, warps)}, vmap=True)["v"]
            for b in (False, True)}
    return cfg_kw, arrays, warps, want


@pytest.mark.parametrize("batched", [False, True])
def test_video_axis_matches_jax_vmap(videos, batched):
    cfg_kw, arrays, warps, want = videos
    cfg = TD.DeepOCSortConfig(batched=batched, **cfg_kw)
    dets, emb, w = to_torch(arrays, warps)
    st, out = TD.deepocsort_scan_videos(cfg, dets, emb, w)
    assert out.valid.shape == (V, FV, T) and st.next_id.shape == (V,)
    assert want[batched].valid.any()
    _assert_same(type_np(out), want[batched])
    # each video equals its own single-video run in that mode
    _, o1 = TD.deepocsort_scan(cfg, TDet(*(x[2] for x in dets)), emb[2],
                               w[2])
    _assert_same(type_np(o1), type(out)(*(np.asarray(x[2]) for x in out)))


def _replay_inputs(n=96, seed=0):
    """Slots after birth and a few filter steps, gaps 0..50, mixed need."""
    rng = np.random.default_rng(seed)
    z0 = np.column_stack([rng.uniform(100, 900, (n, 2)),
                          rng.uniform(20, 200, (n, 2))])
    x, P = TD._nkf_initiate(torch.from_numpy(z0))
    for _ in range(3):
        x, P = TD._nkf_predict(x, P, torch.zeros(n, dtype=torch.bool))
        x, P = TD._nkf_update(
            x, P, torch.from_numpy(z0 + rng.normal(0, 3, (n, 4))))
    zp = torch.from_numpy(z0 + rng.normal(0, 5, (n, 4)))
    zn = torch.from_numpy(z0 + rng.normal(0, 30, (n, 4)))
    gap = torch.from_numpy(rng.integers(1, 51, n).astype(np.int32))
    gap[:3] = torch.tensor([0, 50, 50], dtype=torch.int32)
    need = torch.from_numpy(rng.uniform(size=n) < 0.7)
    need[:3] = True
    return x, P, zp, zn, gap, need


@pytest.mark.parametrize("check", ["jax", "per_slot"])
def test_oru_replay_nkf_plain(check):
    """jax: oru_replay_nkf_plain (and the wrapper on CPU tensors) against
    JAX's _nkf_oru_replay_batch at gaps up to 50, x and P within rtol 1e-5
    / atol 1e-4. per_slot: each of the first 32 slots (gaps 0, 50, 50 and
    random) replayed alone to its own gap (what the CUDA kernel does, one
    thread per slot) equals the masked loop to the largest gap; slots that
    do not replay keep the frozen state."""
    ins = _replay_inputs()
    gx, gP = oru_replay_nkf_plain(*ins)
    if check == "jax":
        jx, jP = jax.jit(JD._nkf_oru_replay_batch)(
            *(jnp.asarray(t.numpy()) for t in ins))
        np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(gP.numpy(), np.asarray(jP), rtol=1e-5,
                                   atol=1e-4)
        wx, wP = oru_replay_nkf(*ins)
        assert torch.equal(wx, gx) and torch.equal(wP, gP)
        return
    x, P, zp, zn, gap, need = ins
    for s in range(32):
        one = [t[s:s + 1] for t in ins]
        sx, sP = oru_replay_nkf_plain(*one)
        torch.testing.assert_close(sx[0], gx[s], rtol=1e-12, atol=1e-9)
        torch.testing.assert_close(sP[0], gP[s], rtol=1e-12, atol=1e-9)
        if not (need[s] and gap[s] > 0):
            assert torch.equal(gx[s], x[s]) and torch.equal(gP[s], P[s])


def test_nkf_matches_jax():
    """_nkf_initiate, _nkf_predict (frozen and not, one size velocity
    driving its size negative) and _nkf_update against JAX in float64,
    within rtol 1e-12."""
    rng = np.random.default_rng(3)
    z = np.column_stack([rng.uniform(100, 500, (6, 2)),
                         rng.uniform(20, 200, (6, 2))])
    zs = z + rng.normal(0, 4, (6, 4))
    frozen = np.array([False, True, False, True, False, False])

    @jax.jit
    def jax_nkf(z, zs, frozen):
        x, P = jax.vmap(lambda v: JD._nkf_initiate(v, z.dtype))(z)
        x = x.at[0, 6].set(-500.0)
        x1, P1 = jax.vmap(JD._nkf_predict)(x, P, frozen)
        return x, P, (x1, P1), jax.vmap(JD._nkf_update)(x1, P1, zs)

    jx, jP, jpred, jupd = jax_nkf(*map(jnp.asarray, (z, zs, frozen)))
    tx, tP = TD._nkf_initiate(torch.from_numpy(z))
    tx[0, 6] = -500.0
    pred = TD._nkf_predict(tx, tP, torch.from_numpy(frozen))
    upd = TD._nkf_update(*pred, torch.from_numpy(zs))
    for got, want in ((tx, jx), (tP, jP), *zip(pred, jpred),
                      *zip(upd, jupd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    assert pred[0][0, 6] == 0.0 and pred[0][1, 6] == 0.0


def test_config_defaults_match_jax():
    """The port's config carries the JAX config's fields and defaults."""
    j = {f.name: f.default for f in dataclasses.fields(JD.DeepOCSortConfig)}
    t = {f.name: f.default for f in dataclasses.fields(TD.DeepOCSortConfig)}
    assert j == t
