"""The port's KPR parts path, uint8 frames -> YOLOX -> NMS -> device crops ->
KPR part features -> BPBReID-StrongSORT, vs the JAX package's
``fused_detect_parts_track`` on the CPU (the tiny geometry of
test_fused_pipeline.py's parts test: YOLOX-tiny at 128, a one-block KPR on
32 x 16 crops, 12 detection slots, chunks of 4).

Run promptless and with a stub ``pose_fn`` (keypoints placed on each box),
each with ``embed_buckets`` None and (4, 8, 12): detections and tracks
equal id for id, embeddings within 1e-4 (the crops' sample positions are
computed in f32 here and in f64 by JAX under x64). The JAX program is
compiled once per prompt mode, at full width, in a module fixture; the
JAX package's own test_fused_parts_buckets_exact holds its bucketed and
full-width runs equal, so each port run is held against the JAX run of
its prompt mode.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.engine import fused as JF
from tracklab_tpu.models.kpr import KPR as JKPR
from tracklab_tpu.models.yolox import YOLOX as JYOLOX
from tracklab_tpu.trackers import bpbreid_strongsort as JB
from tracklab_torch.engine import fused as TF
from tracklab_torch.models.convert import kpr_from_flax, yolox_from_flax
from tracklab_torch.models.kpr import KPR
from tracklab_torch.models.yolox import YOLOX
from tracklab_torch.trackers import bpbreid_strongsort as TB

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

F, CHUNK, D, K, SIZE = 8, 4, 12, 17, 128
KPR_ARCH = dict(num_parts=2, dim_reduce_output=16, img_size=(32, 16),
                patch_size=8, stride=8, embed_dim=32, depth=1, num_heads=2)
BUCKETS = (None, (4, 8, D))
# stub pose: keypoint k at fraction (U[k], V[k]) of its box, confidence C[k]
_rng = np.random.default_rng(9)
U, VV = _rng.uniform(0.1, 0.9, K), np.linspace(0.05, 0.95, K)
C = _rng.uniform(0.1, 1.0, K)


def _static_frames(n, seed):
    """Quasi-static video (tests/test_fused_pipeline.py:_static_frames)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(8, 247, (1, SIZE, SIZE, 3))
    jitter = rng.integers(-4, 5, (n, SIZE, SIZE, 3))
    return np.clip(base + jitter, 0, 255).astype(np.uint8)


def _jax_pose(frames, boxes):
    l, t, r, b = (boxes[..., i, None] for i in range(4))
    u, v, c = (jnp.asarray(a, jnp.float32) for a in (U, VV, C))
    return jnp.stack([l + (r - l) * u, t + (b - t) * v,
                      jnp.broadcast_to(c, l.shape[:-1] + (K,))], axis=-1)


def _torch_pose(frames, boxes):
    l, t, r, b = (boxes[..., i, None] for i in range(4))
    u, v, c = (torch.tensor(a, dtype=torch.float32) for a in (U, VV, C))
    return torch.stack([l + (r - l) * u, t + (b - t) * v,
                        c.expand(l.shape[:-1] + (K,))], dim=-1)


def _cfg(mod, with_pose):
    return mod.BPBReIDStrongSortConfig(
        motion_criterium="oks" if with_pose else "iou", n_parts=3,
        embed_dim=16, n_keypoints=K, max_tracks=16, max_dets=D, n_init=1,
        max_dist=0.8)


@pytest.fixture(scope="module")
def setup():
    jy = JYOLOX(num_classes=1, variant="tiny")
    # jitted inits: the eager values, one compile instead of one per op
    yv = jax.jit(partial(jy.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    jk = JKPR(**KPR_ARCH)
    kv = jax.jit(partial(jk.init, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 16, 3)),
        jnp.zeros((1, 32, 16, jk.n_prompt_ch)))
    rng = np.random.default_rng(1)
    kv = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0, 0.05, np.shape(a)).astype(np.float32), kv)
    frames = _static_frames(F, seed=11)
    ty = YOLOX(num_classes=1, variant="tiny", device="cpu")
    ty.load_state_dict(yolox_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              yv)),
                       strict=True)
    # the score threshold halfway between two adjacent scores (the port's
    # detector gives the JAX scores to ~1e-7), so no score sits on it
    probe = TF.make_yolox_detect_fn(ty, conf_threshold=0.0, max_dets=D)(
        torch.from_numpy(frames))
    scores = np.sort(probe.conf[probe.valid].numpy())[::-1]
    i = min(F * D // 2, len(scores) - 2)
    conf = float((scores[i] + scores[i + 1]) / 2)
    detect = JF.make_yolox_detect_fn(jy, yv, conf_threshold=conf,
                                     max_dets=D)
    embed = JF.make_kpr_embed_fn(jk, kv, crop_size=(32, 16),
                                 n_prompt_ch=jk.n_prompt_ch)
    ref = {}
    for with_pose in (False, True):
        cfg = _cfg(JB, with_pose)
        run = jax.jit(lambda f, cfg=cfg, wp=with_pose:
                      JF.fused_detect_parts_track(
                          detect, embed, partial(JB.bpbreid_step, cfg),
                          JB.bpbreid_init(cfg), f, CHUNK,
                          min_confidence=0.2, n_parts=3, embed_dim=16,
                          n_keypoints=K, pose_fn=_jax_pose if wp else None,
                          return_embeddings=True))
        ref[with_pose] = jax.tree_util.tree_map(np.asarray,
                                                run(jnp.asarray(frames)))
    tk = KPR(device="cpu", **KPR_ARCH)
    tk.load_state_dict(kpr_from_flax(kv), strict=True)
    return frames, conf, ty, tk, ref


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("with_pose", [False, True])
def test_parts_path_matches_jax(setup, with_pose, buckets):
    frames, conf, ty, tk, ref = setup
    _, jd, jr, jkp, jo = ref[with_pose]
    cfg = _cfg(TB, with_pose)
    detect = TF.make_yolox_detect_fn(ty, conf_threshold=conf, max_dets=D)
    embed = TF.make_kpr_embed_fn(tk, crop_size=(32, 16),
                                 n_prompt_ch=tk.n_prompt_ch)
    _, td, tr, tkp, to = TF.fused_detect_parts_track(
        detect, embed, partial(TB.bpbreid_step, cfg),
        TB.bpbreid_init(cfg, device="cpu"), torch.from_numpy(frames), CHUNK,
        min_confidence=0.2, n_parts=3, embed_dim=16, n_keypoints=K,
        pose_fn=_torch_pose if with_pose else None, embed_buckets=buckets,
        return_embeddings=True)

    valid = jd.valid
    live = valid.sum(1).max()
    assert 0 < live < D, "need a non-trivial live prefix"
    np.testing.assert_array_equal(td.valid.numpy(), valid)
    np.testing.assert_array_equal(td.ref.numpy(), jd.ref)
    np.testing.assert_allclose(td.ltrb.numpy()[valid], jd.ltrb[valid],
                               atol=1e-4)
    np.testing.assert_allclose(tr["embeddings"].numpy(), jr["embeddings"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tr["visibility"].numpy(),
                                  jr["visibility"])
    if with_pose:
        np.testing.assert_allclose(tkp.numpy(), jkp, rtol=1e-5, atol=1e-4)
    else:
        assert tkp is None and jkp is None

    ov = jo.valid
    assert ov.any(), "tracker emitted nothing"
    np.testing.assert_array_equal(to.valid.numpy(), ov)
    np.testing.assert_array_equal(to.track_id.numpy()[ov], jo.track_id[ov])
    np.testing.assert_allclose(to.ltrb.numpy()[ov], jo.ltrb[ov], rtol=1e-5,
                               atol=1e-3)


def test_bucketed_embed_pads_to_full_width():
    """The live-prefix run zero-pads every output (nested too) back to D
    and rejects bucket lists that do not end at D."""
    boxes = torch.zeros(2, 6, 4)
    valid = torch.zeros(2, 6, dtype=torch.bool)
    valid[0, :3] = True
    seen = []

    def stage(fr, bx):
        seen.append(bx.shape[1])
        return {"reid": {"e": torch.ones(2, bx.shape[1], 3)},
                "kp": torch.ones(2, bx.shape[1], 5, 3)}

    out = TF._bucketed_embed(stage, None, boxes, valid, (2, 4, 6))
    assert seen == [4]
    assert out["reid"]["e"].shape == (2, 6, 3) and out["kp"].shape[1] == 6
    assert out["reid"]["e"][:, 4:].abs().sum() == 0
    with pytest.raises(ValueError):
        TF._bucketed_embed(stage, None, boxes, valid, (2, 4))
