"""tracklab_torch Kalman filter and OC-SORT vs the JAX package on the CPU.

The tracker must match the JAX ``ocsort_scan`` id for id on the randomized
streams of test_ocsort.py (valid and track_id exactly equal)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ocsort import CFG_KW, synth_stream
from tracklab_tpu.ops.kalman import XYSRFilter as JKF
from tracklab_tpu.trackers import common as JC
from tracklab_tpu.trackers import ocsort as JO
from tracklab_torch.ops.kalman import XYSRFilter as TKF
from tracklab_torch.trackers import common as TC
from tracklab_torch.trackers import ocsort as TO

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


def _kf_inputs(seed, T=8):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(50, 500, (T, 2)),
                        rng.uniform(500, 5000, (T, 1)),
                        rng.uniform(0.3, 2.0, (T, 1)),
                        rng.normal(0, 3, (T, 3))], axis=1)
    A = rng.normal(size=(T, 7, 7))
    P = A @ A.transpose(0, 2, 1) + np.eye(7) * 5.0
    z = x[:, :4] + rng.normal(0, [2, 2, 50, 0.05], (T, 4))
    return x, P, z


def test_kalman_predict_update_match_jax():
    x, P, z = _kf_inputs(0)
    jx, jP = jax.jit(JKF.predict_batch)(jnp.asarray(x), jnp.asarray(P))
    tx, tP = TKF.predict(torch.from_numpy(x), torch.from_numpy(P))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5, atol=1e-5)
    jx, jP = jax.jit(JKF.update_batch)(jnp.asarray(x), jnp.asarray(P),
                                       jnp.asarray(z))
    tx, tP = TKF.update(torch.from_numpy(x), torch.from_numpy(P),
                              torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TKF.to_ltrb(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.jit(JKF.to_ltrb_batch)(x)),
                               rtol=1e-5, atol=1e-5)


def test_kalman_oru_replay_matches_jax():
    x, P, z = _kf_inputs(1)
    _, _, z_prev = _kf_inputs(2)
    gap = np.array([1, 2, 3, 5, 1, 4, 2, 7], np.int32)
    need = np.array([1, 1, 0, 1, 0, 1, 1, 0], bool)
    jx, jP = jax.jit(JKF.oru_replay_batch)(*map(jnp.asarray,
                                                (x, P, z_prev, z, gap, need)))
    tx, tP = TKF.oru_replay_batch(*map(torch.from_numpy,
                                       (x, P, z_prev, z, gap, need)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_scan(cfg):
    return jax.jit(lambda d: JO.ocsort_scan(cfg, d))


def _run_both(frames, cfg):
    per = [(f[:, :4], f[:, 4], f[:, 5], f[:, 6].astype(int)) for f in frames]
    jd = [JC.pad_detections(*p, capacity=cfg.max_dets, dtype=np.float64)
          for p in per]
    jd = JC.Detections(*[jnp.stack([getattr(d, n) for d in jd])
                         for n in JC.Detections._fields])
    _, jout = _jax_scan(cfg)(jd)
    td = [TC.pad_detections(*p, capacity=cfg.max_dets, dtype=torch.float64,
                            device="cpu") for p in per]
    td = TC.Detections(*[torch.stack([getattr(d, n) for d in td])
                         for n in TC.Detections._fields])
    kw = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "batched"}
    _, tout = TO.ocsort_scan(TO.OCSortConfig(**kw), td)
    return tout, jout


def _assert_same_tracks(tout, jout):
    np.testing.assert_array_equal(tout.valid.numpy(), np.asarray(jout.valid))
    v = np.asarray(jout.valid)
    np.testing.assert_array_equal(tout.track_id.numpy()[v],
                                  np.asarray(jout.track_id)[v])
    np.testing.assert_array_equal(tout.ref.numpy()[v], np.asarray(jout.ref)[v])
    np.testing.assert_allclose(tout.ltrb.numpy()[v], np.asarray(jout.ltrb)[v],
                               rtol=1e-5, atol=1e-4)
    assert tout.track_id.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_byte", [False, True])
def test_ocsort_matches_jax_random_stream(seed, use_byte):
    cfg = JO.OCSortConfig(use_byte=use_byte, max_tracks=64, max_dets=32,
                          **CFG_KW)
    tout, jout = _run_both(synth_stream(seed), cfg)
    assert np.asarray(jout.valid).any()
    _assert_same_tracks(tout, jout)


def test_ocsort_matches_jax_heavy_occlusion():
    frames = synth_stream(7, n_frames=80, n_obj=4, drop=0.35, fp_rate=0.2)
    cfg = JO.OCSortConfig(max_tracks=64, max_dets=32, **CFG_KW)
    _assert_same_tracks(*_run_both(frames, cfg))


def test_ocsort_empty_frames():
    cfg = JO.OCSortConfig(max_tracks=16, max_dets=8, **CFG_KW)
    tout, jout = _run_both([np.zeros((0, 7))] * 5, cfg)
    assert not tout.valid.any()
    _assert_same_tracks(tout, jout)


def test_ocsort_capacity_overflow():
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(4):
        n = 30
        c = rng.uniform(0, 1500, (n, 2))
        s = rng.uniform(30, 80, (n, 2))
        frames.append(np.concatenate([
            c, c + s, rng.uniform(0.6, 1.0, (n, 1)),
            np.zeros((n, 1)), np.arange(n)[:, None]], axis=1))
    cfg = JO.OCSortConfig(max_tracks=16, max_dets=32, **CFG_KW)
    tout, jout = _run_both(frames, cfg)
    _assert_same_tracks(tout, jout)
    for f in range(len(frames)):
        ids = tout.track_id[f][tout.valid[f]].tolist()
        assert len(ids) == len(set(ids))


def test_birth_scatter_exact_for_int_and_bool():
    det2slot = torch.tensor([2, -1, 0], dtype=torch.int32)
    birth = det2slot >= 0
    arr_i = torch.tensor([7, 8, 9, 10], dtype=torch.int32)
    got = TC.birth_scatter(det2slot, birth, arr_i,
                           torch.tensor([2 ** 30 + 1, 5, -3], dtype=torch.int32))
    assert got.tolist() == [-3, 8, 2 ** 30 + 1, 10] and got.dtype == torch.int32
    arr_b = torch.tensor([True, True, False, True])
    got_b = TC.birth_scatter(det2slot, birth, arr_b,
                             torch.tensor([True, False, False]))
    assert got_b.tolist() == [False, True, True, True]


def test_claim_slots_and_resets_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        free = rng.uniform(size=12) < 0.4
        want = rng.uniform(size=9) < 0.6
        j = np.asarray(JC.claim_slots(jnp.asarray(free), jnp.asarray(want)))
        t = TC.claim_slots(torch.from_numpy(free), torch.from_numpy(want))
        np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(TC.concat_resets(3, 4, device="cpu").numpy(),
                                  np.asarray(JC.concat_resets(3, 4)))
