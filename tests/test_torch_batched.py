"""tracklab_torch multi-video tracking over a leading video axis vs the JAX
package's vmapped scans on the CPU.

``ocsort_scan_videos`` and ``bytetrack_scan_videos``, in both ``batched``
modes, must equal ``jax.vmap(lambda d: scan(bcfg, d))`` with the cond-free
config id for id (the deployment shape of test_batched_mode.py:132-166),
and each video must equal its own single-video run in the port. The JAX
references are computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ocsort import CFG_KW, synth_stream
from tracklab_tpu.trackers import bytetrack as JB
from tracklab_tpu.trackers import common as JC
from tracklab_tpu.trackers import ocsort as JO
from tracklab_torch.trackers import bytetrack as TB
from tracklab_torch.trackers import common as TC
from tracklab_torch.trackers import ocsort as TO

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

V, F, T, D = 4, 30, 32, 16
BT_KW = dict(track_thresh=0.5, track_buffer=12)


def _streams():
    return [synth_stream(20 + v, n_frames=F, n_obj=4) for v in range(V)]


def _padded(streams):
    """(V, F, D) float64 numpy fields of the padded detections."""
    vids = []
    for frames in streams:
        per = [JC.pad_detections(f[:, :4], f[:, 4], f[:, 5],
                                 f[:, 6].astype(int), capacity=D,
                                 dtype=np.float64) for f in frames]
        vids.append([np.stack([np.asarray(getattr(d, n)) for d in per])
                     for n in JC.Detections._fields])
    return [np.stack(x) for x in zip(*vids)]


def _jax_vmapped(scan, cfg, fields):
    batch = JC.Detections(*map(jnp.asarray, fields))
    _, out = jax.jit(jax.vmap(lambda d: scan(cfg, d)))(batch)
    return type(out)(*(np.asarray(x) for x in out))


def _configs(tracker, batched):
    if tracker == "ocsort":
        return (JO.OCSortConfig(max_tracks=T, max_dets=D, batched=True,
                                **CFG_KW),
                TO.OCSortConfig(max_tracks=T, max_dets=D, batched=batched,
                                **CFG_KW))
    return (JB.ByteTrackConfig(max_tracks=T, max_dets=D, batched=True,
                               **BT_KW),
            TB.ByteTrackConfig(max_tracks=T, max_dets=D, batched=batched,
                               **BT_KW))


@pytest.fixture(scope="module")
def data():
    fields = _padded(_streams())
    ref = {"ocsort": _jax_vmapped(JO.ocsort_scan, _configs("ocsort", True)[0],
                                  fields),
           "bytetrack": _jax_vmapped(JB.bytetrack_scan,
                                     _configs("bytetrack", True)[0], fields)}
    dets = TC.Detections(*map(torch.from_numpy, fields))
    return dets, ref


def _assert_same(got, want):
    """valid and track_id/ref equal, boxes within 1e-4 (float64 runs)."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(got.valid), valid)
    assert valid.any()
    for name in ("track_id", "ref"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name))[valid],
                                      np.asarray(getattr(want, name))[valid])
    np.testing.assert_allclose(np.asarray(got.ltrb)[valid],
                               np.asarray(want.ltrb)[valid], rtol=1e-5,
                               atol=1e-4)


_SCAN_VIDEOS = {"ocsort": TO.ocsort_scan_videos,
                "bytetrack": TB.bytetrack_scan_videos}
_SCAN = {"ocsort": TO.ocsort_scan, "bytetrack": TB.bytetrack_scan}


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("tracker", ["ocsort", "bytetrack"])
def test_video_axis_matches_jax_vmap(data, tracker, batched):
    dets, ref = data
    _, cfg = _configs(tracker, batched)
    st, out = _SCAN_VIDEOS[tracker](cfg, dets)
    assert out.valid.shape == (V, F, T)
    assert out.track_id.dtype == torch.int32
    assert st.next_id.shape == (V,) and st.frame_count.tolist() == [F] * V
    _assert_same(type(out)(*(x.numpy() for x in out)), ref[tracker])


@pytest.mark.parametrize("tracker", ["ocsort", "bytetrack"])
def test_each_video_equals_its_single_video_run(data, tracker):
    """Every per-video reduction stays inside its video: V videos at once
    in batched mode equal V single-video runs in the default mode."""
    dets, _ = data
    _, cfg = _configs(tracker, True)
    _, out = _SCAN_VIDEOS[tracker](cfg, dets)
    single_cfg = dataclasses.replace(cfg, batched=False)
    for v in range(V):
        _, one = _SCAN[tracker](single_cfg,
                                TC.Detections(*(x[v] for x in dets)))
        _assert_same(type(out)(*(x[v].numpy() for x in out)),
                     type(one)(*(x.numpy() for x in one)))


def test_slot_helpers_over_a_video_axis_match_jax_vmap():
    rng = np.random.default_rng(5)
    free = rng.uniform(size=(V, 12)) < 0.4
    want = rng.uniform(size=(V, 9)) < 0.6
    j = np.asarray(jax.vmap(JC.claim_slots)(jnp.asarray(free),
                                            jnp.asarray(want)))
    t = TC.claim_slots(torch.from_numpy(free), torch.from_numpy(want))
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(TC.cumsum_rank(torch.from_numpy(want)),
                                  np.cumsum(want, axis=1) - 1)
    birth = t >= 0
    arr = torch.arange(V * 12 * 2, dtype=torch.float64).reshape(V, 12, 2)
    val = -torch.arange(V * 9 * 2, dtype=torch.float64).reshape(V, 9, 2) - 1
    got = TC.birth_scatter(t, birth, arr, val)
    exp = arr.clone()
    for v in range(V):
        for d in range(9):
            if birth[v, d]:
                exp[v, t[v, d]] = val[v, d]
    assert torch.equal(got, exp)


def test_reset_per_video_and_invert_match():
    init = TO.ocsort_init(TO.OCSortConfig(max_tracks=4, max_dets=2),
                          device="cpu")
    init_v = TC.repeat_state(init, 3)
    carry = init_v._replace(next_id=torch.tensor([5, 6, 7],
                                                 dtype=torch.int32))
    step = TC.reset_wrapped_step(lambda st, x: (st, x), init_v)
    st, _ = step(carry, (None, torch.tensor([False, True, False])))
    assert st.next_id.tolist() == [5, 0, 7]
    d2t = torch.tensor([[2, -1, 0], [-1, -1, 1]], dtype=torch.int32)
    assert TC.invert_match(d2t, 4).tolist() == [[2, -1, 0, -1],
                                                [-1, 2, -1, -1]]
