"""tracklab_torch ByteTrack (XYAHFilter, xyah boxes, matching_limit) vs the
JAX package and the numpy/scipy oracle on the CPU.

Single-video ByteTrack must match the JAX ``bytetrack_scan`` and
``ByteTrackOracle`` frame for frame on the streams of test_bytetrack.py (the
cond-free ``batched`` mode on two of them; test_torch_batched.py holds it
over a video axis). The JAX references are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles.bytetrack_oracle import ByteTrackOracle
from test_bytetrack import KW, run_jax
from test_ocsort import assert_frames_equal, synth_stream
from tracklab_tpu.ops import boxes as JB
from tracklab_tpu.ops.kalman import XYAHFilter as JKF
from tracklab_tpu.trackers.bytetrack import ByteTrackConfig as JConfig
from tracklab_torch.ops import boxes as TB
from tracklab_torch.ops.kalman import XYAHFilter as TKF
from tracklab_torch.trackers import common as TC
from tracklab_torch.trackers.bytetrack import (ByteTrackConfig,
                                               bytetrack_scan)

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


def test_xyah_box_formats_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 500, (2, 9, 2))
    b = np.concatenate([xy, xy + rng.uniform(5, 80, (2, 9, 2))], -1)
    got = TB.ltrb_to_ltwh(torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(JB.ltrb_to_ltwh(b)),
                               rtol=1e-12)
    np.testing.assert_allclose(TB.ltwh_to_xyah(got).numpy(),
                               np.asarray(JB.ltwh_to_xyah(
                                   JB.ltrb_to_ltwh(b))), rtol=1e-12)


def test_xyah_filter_matches_jax():
    rng = np.random.default_rng(1)
    T = 6
    z = np.concatenate([rng.uniform(50, 500, (T, 2)),
                        rng.uniform(0.3, 2.0, (T, 1)),
                        rng.uniform(40, 200, (T, 1))], axis=1)
    jx, jP = jax.vmap(JKF.initiate)(jnp.asarray(z))
    tx, tP = TKF.initiate(torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-12)
    x = np.asarray(jx) + np.concatenate([np.zeros((T, 4)),
                                         rng.normal(0, 2, (T, 4))], 1)
    A = rng.normal(size=(T, 8, 8))
    P = A @ A.transpose(0, 2, 1) + np.eye(8) * 4.0
    jpx, jpP = jax.vmap(JKF.predict)(jnp.asarray(x), jnp.asarray(P))
    # two videos of T tracks: the leading axes are batch axes
    x2, P2 = torch.from_numpy(np.stack([x, x])), torch.from_numpy(
        np.stack([P, P]))
    tpx, tpP = TKF.predict(x2, P2)
    for v in range(2):
        np.testing.assert_allclose(tpx[v].numpy(), np.asarray(jpx),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(tpP[v].numpy(), np.asarray(jpP),
                                   rtol=1e-10, atol=1e-10)
    zz = z + rng.normal(0, [2, 2, 0.05, 3], (T, 4))
    jux, juP = jax.vmap(JKF.update)(jnp.asarray(x), jnp.asarray(P),
                                    jnp.asarray(zz))
    tux, tuP = TKF.update(torch.from_numpy(x), torch.from_numpy(P),
                          torch.from_numpy(zz))
    np.testing.assert_allclose(tux.numpy(), np.asarray(jux), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(tuP.numpy(), np.asarray(juP), rtol=1e-9,
                               atol=1e-9)


STREAMS = {
    "seed0": dict(seed=0, n_frames=60, n_obj=6, drop=0.15),
    "seed1": dict(seed=1, n_frames=60, n_obj=6, drop=0.15),
    "seed2": dict(seed=2, n_frames=60, n_obj=6, drop=0.15),
    "heavy": dict(seed=11, n_frames=80, n_obj=5, drop=0.35, fp_rate=0.4),
}


def _frames(name):
    if name == "empty_low_conf":
        return [np.zeros((0, 7))] + [
            np.array([[10, 10, 50, 50, 0.3, 0, 0]], np.float64)] * 3
    return synth_stream(**STREAMS[name])


def _cap(name):
    return (16, 8) if name == "empty_low_conf" else (64, 32)


@pytest.fixture(scope="module")
def references():
    """Per stream: (JAX bytetrack_scan frames, oracle frames)."""
    out = {}
    for name in list(STREAMS) + ["empty_low_conf"]:
        frames = _frames(name)
        T, D = _cap(name)
        orc = ByteTrackOracle(**KW)
        out[name] = (run_jax(frames, JConfig(max_tracks=T, max_dets=D, **KW)),
                     [orc.update(f) for f in frames])
    return out


def run_torch(frames, cfg):
    per = [TC.pad_detections(f[:, :4], f[:, 4], f[:, 5], f[:, 6].astype(int),
                             capacity=cfg.max_dets, dtype=torch.float64,
                             device="cpu") for f in frames]
    dets = TC.Detections(*(torch.stack(x) for x in zip(*per)))
    _, out = bytetrack_scan(cfg, dets)
    assert out.track_id.dtype == torch.int32
    res = []
    for f in range(len(frames)):
        res.append([(out.ltrb[f, t].numpy(), int(out.track_id[f, t]),
                     float(out.cls[f, t]), float(out.conf[f, t]),
                     int(out.ref[f, t]))
                    for t in torch.nonzero(out.valid[f])[:, 0].tolist()])
    return res


@pytest.mark.parametrize("name,batched", [
    (name, False) for name in list(STREAMS) + ["empty_low_conf"]]
    + [("seed0", True), ("empty_low_conf", True)])
def test_bytetrack_matches_jax_and_oracle(references, name, batched):
    T, D = _cap(name)
    cfg = ByteTrackConfig(max_tracks=T, max_dets=D, batched=batched, **KW)
    got = run_torch(_frames(name), cfg)
    want_jax, want_orc = references[name]
    for f, (g, wj, wo) in enumerate(zip(got, want_jax, want_orc)):
        assert_frames_equal(g, wj, f)
        assert_frames_equal(g, wo, f)
    if name == "empty_low_conf":
        assert all(len(g) == 0 for g in got)
    else:
        assert sum(len(g) for g in got) > 0


def test_config_matches_jax_defaults():
    got = dataclasses.asdict(ByteTrackConfig())
    want = dataclasses.asdict(JConfig())
    assert got == want
    assert ByteTrackConfig().max_time_lost == JConfig().max_time_lost
