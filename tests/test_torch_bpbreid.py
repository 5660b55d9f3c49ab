"""tracklab_torch BPBReID-StrongSORT and its ops (XYAHNSAHFilter, OKS,
min_cost_matching) vs the JAX package on the CPU.

The tracker runs in float64 on both sides (tests/conftest.py enables x64),
so ids must match exactly: single-video scans for IoU and OKS motion and
for the bot_sort strategy, with the cost instrumentation, and V = 3 videos
over the video axis in both ``batched`` modes against ``jax.vmap`` of the
cond-free JAX scan. The JAX references are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.ops import assignment as JA
from tracklab_tpu.ops import kalman as JKF
from tracklab_tpu.ops import oks as JO
from tracklab_tpu.trackers import bpbreid_strongsort as JB
from tracklab_tpu.trackers.common import Detections as JDet
from tracklab_torch.ops import assignment as TA
from tracklab_torch.ops import kalman as TKF
from tracklab_torch.ops import oks as TO
from tracklab_torch.trackers import bpbreid_strongsort as TB
from tracklab_torch.trackers.common import Detections as TDet

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

F, D, P, E, K, T, V = 30, 8, 4, 16, 17, 16, 3
CFG_KW = dict(n_parts=P, embed_dim=E, n_keypoints=K, max_tracks=T,
              max_dets=D, n_init=2, max_dist=0.3)
RUNS = {"iou": dict(motion_criterium="iou", emit_costs=True),
        "oks": dict(motion_criterium="oks"),
        "bot_sort": dict(motion_criterium="iou",
                         matching_strategy="bot_sort")}


def _stream(seed):
    """The stream of test_bpbreid_oks.py (4 objects, noisy part features,
    keypoints, 15 % dropouts), with object 0 gone for frames 8-18 so its
    track coasts past the KF freeze and is re-acquired. float64 arrays:
    ltrb, conf, valid, feat, vis, kps."""
    rng = np.random.default_rng(seed)
    n_obj = 4
    base_feat = rng.normal(size=(n_obj, P, E))
    pos = rng.uniform(200, 800, (n_obj, 2))
    vel = rng.uniform(-2, 2, (n_obj, 2))
    ltrb = np.zeros((F, D, 4))
    conf = np.zeros((F, D))
    valid = np.zeros((F, D), bool)
    feat = np.zeros((F, D, P, E))
    vis = np.zeros((F, D, P))
    kps = np.zeros((F, D, K, 3))
    for f in range(F):
        pos = pos + vel
        slot = 0
        for k in range(n_obj):
            if rng.uniform() < 0.15 or (k == 0 and 8 <= f <= 18):
                continue
            c = pos[k]
            ltrb[f, slot] = [c[0], c[1], c[0] + 60, c[1] + 140]
            conf[f, slot] = rng.uniform(0.7, 1.0)
            valid[f, slot] = True
            feat[f, slot] = base_feat[k] + rng.normal(0, 0.05, (P, E))
            vis[f, slot] = rng.uniform(0.5, 1.0, P) * (rng.uniform(size=P)
                                                       < 0.8)
            kps[f, slot, :, 0] = c[0] + np.linspace(5, 55, K) \
                + rng.normal(0, 1, K)
            kps[f, slot, :, 1] = c[1] + np.linspace(10, 130, K)
            kps[f, slot, :, 2] = 1.0
            slot += 1
    return ltrb, conf, valid, feat, vis, kps


def _jax_inputs(s):
    ltrb, conf, valid, feat, vis, kps = map(jnp.asarray, s)
    lead = conf.shape
    dets = JDet(ltrb, conf, jnp.ones(lead), jnp.broadcast_to(
        jnp.arange(D, dtype=jnp.int32), lead), valid)
    return dets, feat, vis, kps


def _torch_inputs(s):
    ltrb, conf, valid, feat, vis, kps = map(torch.from_numpy, s)
    lead = conf.shape
    dets = TDet(ltrb, conf, torch.ones(lead, dtype=torch.float64),
                torch.arange(D, dtype=torch.int32).expand(lead), valid)
    return dets, feat, vis, kps


def _np(out):
    return type(out)(*(None if x is None else np.asarray(x) for x in out))


@pytest.fixture(scope="module")
def ref():
    s0 = _stream(0)
    single = {}
    for name, kw in RUNS.items():
        cfg = JB.BPBReIDStrongSortConfig(**CFG_KW, **kw)
        scan = jax.jit(lambda d, fe, vi, kp, cfg=cfg:
                       JB.bpbreid_scan(cfg, d, fe, vi, kp)[1])
        single[name] = _np(scan(*_jax_inputs(s0)))
    vids = [_stream(10 + v) for v in range(V)]
    stacked = tuple(np.stack(x) for x in zip(*vids))
    bcfg = JB.BPBReIDStrongSortConfig(**CFG_KW, batched=True)
    vm = jax.jit(jax.vmap(lambda d, fe, vi, kp:
                          JB.bpbreid_scan(bcfg, d, fe, vi, kp)[1]))
    return s0, single, stacked, _np(vm(*_jax_inputs(stacked)))


def _assert_same(got, want, costs=False):
    valid = want.valid
    assert valid.any()
    np.testing.assert_array_equal(got.valid, valid)
    for name in ("track_id", "ref", "hits", "age", "tstate"):
        np.testing.assert_array_equal(getattr(got, name)[valid],
                                      getattr(want, name)[valid], name)
    for name in ("ltrb", "pred_ltrb", "conf"):
        np.testing.assert_allclose(getattr(got, name)[valid],
                                   getattr(want, name)[valid], rtol=1e-9,
                                   atol=1e-7, err_msg=name)
    if costs:
        np.testing.assert_array_equal(got.matched_stage, want.matched_stage)
        np.testing.assert_array_equal(got.cost_track_valid,
                                      want.cost_track_valid)
        tv = want.cost_track_valid[:, None, :]
        for name in ("costs_r", "costs_s", "costs_k"):
            g, w = getattr(got, name), getattr(want, name)
            np.testing.assert_allclose(np.where(tv, g, 0), np.where(tv, w, 0),
                                       rtol=1e-9, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(got.matched_cost, want.matched_cost,
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("run", list(RUNS))
def test_single_video_matches_jax(ref, run):
    s0, single, _, _ = ref
    cfg = TB.BPBReIDStrongSortConfig(**CFG_KW, **RUNS[run])
    dets, feat, vis, kps = _torch_inputs(s0)
    st, out = TB.bpbreid_scan(cfg, dets, feat, vis, kps)
    assert out.valid.shape == (F, T) and st.frame.item() == F
    assert out.track_id.dtype == torch.int32
    _assert_same(_np(out), single[run], costs=cfg.emit_costs)
    if run == "iou":
        # the coasting track froze and came back with its id
        tsu = out.time_since_update.numpy()
        assert (tsu >= cfg.max_kalman_prediction_without_update).any()


@pytest.mark.parametrize("batched", [True, False])
def test_video_axis_matches_jax_vmap(ref, batched):
    _, _, stacked, want = ref
    cfg = TB.BPBReIDStrongSortConfig(**CFG_KW, batched=batched)
    st, out = TB.bpbreid_scan_videos(cfg, *_torch_inputs(stacked))
    assert out.valid.shape == (V, F, T) and st.next_id.shape == (V,)
    _assert_same(_np(out), want)
    # each video equals its own single-video run
    one = dataclasses.replace(cfg, batched=False)
    dets, feat, vis, kps = _torch_inputs(stacked)
    _, o1 = TB.bpbreid_scan(one, TDet(*(x[1] for x in dets)), feat[1],
                            vis[1], kps[1])
    _assert_same(_np(o1), _np(type(out)(*(None if x is None else x[1]
                                          for x in out))))


def test_part_based_distance_and_nsa_filter_match_jax():
    rng = np.random.default_rng(3)
    tf, df = rng.normal(size=(5, P, E)), rng.normal(size=(7, P, E))
    tv = rng.uniform(0, 1, (5, P)) * (rng.uniform(size=(5, P)) < 0.7)
    dv = rng.uniform(0, 1, (7, P)) * (rng.uniform(size=(7, P)) < 0.7)
    tv[0] = 0.0
    want = np.asarray(JB.part_based_distance(*map(jnp.asarray,
                                                  (tf, tv, df, dv))))
    got = TB.part_based_distance(*map(torch.from_numpy, (tf, tv, df, dv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)

    z = np.column_stack([rng.uniform(100, 500, (6, 2)),
                         rng.uniform(0.3, 0.7, 6), rng.uniform(50, 200, 6)])
    zs = z[::-1] + rng.normal(0, 3, (6, 4))
    conf = rng.uniform(0.2, 1.0, 6)
    JF, TF = JKF.XYAHNSAHFilter, TKF.XYAHNSAHFilter

    @jax.jit
    def jax_filter(z, zs, conf):
        m, c = jax.vmap(JF.initiate)(z)
        for _ in range(2):
            m, c = jax.vmap(JF.predict)(m, c)
        gates = [jax.vmap(lambda m_, c_: JF.gating_distance(
            m_, c_, zs, op))(m, c) for op in (False, True)]
        return c, gates, jax.vmap(JF.update)(m, c, zs, conf)

    jc, jgates, (jm, ju) = jax_filter(jnp.asarray(z), jnp.asarray(zs),
                                      jnp.asarray(conf))
    tm, tc = TF.initiate(torch.from_numpy(z))
    for _ in range(2):
        tm, tc = TF.predict(tm, tc)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12)
    for op, want in zip((False, True), jgates):
        got = TF.gating_distance(tm, tc, torch.from_numpy(zs), op)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    tm, tc = TF.update(tm, tc, torch.from_numpy(zs), torch.from_numpy(conf))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-12)
    np.testing.assert_allclose(tc.numpy(), np.asarray(ju), rtol=1e-9,
                               atol=1e-9)
    a = rng.normal(size=(4, 2, 2)) + 3 * np.eye(2)
    np.testing.assert_allclose(TKF._inv2(torch.from_numpy(a)).numpy(),
                               np.linalg.inv(a), rtol=1e-12)
    Fm, Hm = TKF._xyah_mats(torch.float64)
    jFm, jHm = JKF._xyah_mats(jnp.float64)
    np.testing.assert_array_equal(Fm.numpy(), np.asarray(jFm))
    np.testing.assert_array_equal(Hm.numpy(), np.asarray(jHm))


def test_oks_matrix_matches_jax():
    rng = np.random.default_rng(8)
    trk = np.zeros((2, 5, 17, 3))
    trk[..., 0] = rng.uniform(100, 300, (2, 5, 17))
    trk[..., 1] = rng.uniform(100, 500, (2, 5, 17))
    trk[..., 2] = rng.uniform(size=(2, 5, 17)) < 0.8
    trk[0, 1] = 0.0                              # degenerate: NaN row
    trk[0, 2, :, 1] = trk[0, 2, :, 0]            # collinear: 45-deg scale
    det = trk[:, ::-1, :, :] + rng.normal(0, 4, (2, 5, 17, 3))
    for v in range(2):
        want = np.asarray(JO.oks_matrix(jnp.asarray(trk[v]),
                                        jnp.asarray(det[v])))
        got = TO.oks_matrix(torch.from_numpy(trk[v]), torch.from_numpy(det[v]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   equal_nan=True)
    both = TO.oks_matrix(torch.from_numpy(trk), torch.from_numpy(det))
    np.testing.assert_allclose(both[1].numpy(), got.numpy(), rtol=0,
                               equal_nan=True)


@pytest.mark.parametrize("shape", [(8, 16), (16, 8), (12, 12)])
def test_min_cost_matching_matches_jax(shape):
    """The 40 draws of test_batched_mode.py, one problem at a time and as
    one stack of 40, in both modes: the same matching as JAX (the default
    mode's fast path is exact, so both modes give JAX's answer)."""
    R, C = shape
    rng = np.random.default_rng(0)
    draws = []
    for _ in range(40):
        cost = rng.normal(size=(R, C)) * rng.uniform(0.1, 3)
        draws.append((cost, rng.uniform(size=R) < 0.8,
                      rng.uniform(size=C) < 0.7))
    m_n = jax.jit(lambda c, r, m: JA.min_cost_matching(c, r, m, 0.7))
    want = np.stack([np.asarray(m_n(*d)) for d in draws])
    cs, rs, ms = (torch.from_numpy(np.stack(x)) for x in zip(*draws))
    for batched in (False, True):
        got = TA.min_cost_matching(cs, rs, ms, 0.7, batched=batched)
        np.testing.assert_array_equal(got.numpy(), want)
    one = TA.min_cost_matching(cs[5], rs[5], ms[5], 0.7)
    np.testing.assert_array_equal(one.numpy(), want[5])
