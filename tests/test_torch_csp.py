"""tracklab_torch CSPLayer, BN folding and K3's weight packing vs the JAX
package on the CPU.

K3 itself runs only on the card (chip_smoke.py holds it against the plain
layer there). Here the plain layer is held against the flax layer and the
Pallas kernel in interpret mode, and the kernel's packed weights are held
against the Pallas kernel through ``_kernel_math``, a plain-torch transcript
of the kernel's arithmetic on the packed tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_csp_pallas import _realistic_variables
from tracklab_tpu.models.yolox import CSPLayer as JCSP
from tracklab_tpu.models.yolox import ConvBnAct as JConv
from tracklab_tpu.ops.csp_pallas import fold_convbn as jfold
from tracklab_tpu.ops.csp_pallas import fused_csplayer as jfused
from tracklab_torch.kernels import csp as K3
from tracklab_torch.models.convert import state_dict_from_flax
from tracklab_torch.models.yolox import CSPLayer, ConvBnAct

SHAPES = [(1, True, 64, 64, 16, 24), (3, True, 128, 128, 8, 8),
          (1, False, 96, 64, 8, 16)]


def _kernel_math(x, p, shortcut):
    """K3's arithmetic in plain torch on NHWC x and pack_csplayer output:
    f32 products, storage-type rounding after each SiLU."""
    B, H, W, cin = x.shape
    dt = p["wm"].dtype
    mm = lambda a, w: a.float() @ w.float()            # noqa: E731
    xm = x.reshape(B, H * W, cin)
    a = F.silu(mm(xm, p["wm"]) + p["bm"]).to(dt)
    s = F.silu(mm(xm, p["ws"]) + p["bs"]).to(dt)
    ch = a.shape[-1]
    for i in range(p["w1"].shape[0]):
        t = F.silu(mm(a, p["w1"][i]) + p["b1"][i]).to(dt)
        tp = F.pad(t.reshape(B, H, W, ch), (0, 0, 1, 1, 1, 1))
        acc = p["b3"][i].expand(B, H * W, ch)
        for dy in range(3):
            for dx in range(3):
                sh = tp[:, dy:dy + H, dx:dx + W].reshape(B, H * W, ch)
                acc = acc + mm(sh, p["w3"][i, dy * 3 + dx])
        y = F.silu(acc)
        a = (y + a.float()).to(dt) if shortcut else y.to(dt)
    out = F.silu(mm(torch.cat([a, s], -1), p["wf"]) + p["bf"])
    return out.reshape(B, H, W, -1).to(dt)


def _rel(got, want):
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


def _pair(n, shortcut, cin, cout, H, W):
    layer = JCSP(cout, n=n, shortcut=shortcut, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, H, W, cin)).astype(np.float32)
    v = _realistic_variables(layer, jnp.asarray(x), seed=n)
    tl = CSPLayer(cin, cout, n, shortcut).eval()
    tl.load_state_dict(state_dict_from_flax(v), strict=True)
    return layer, v, tl, x


@pytest.mark.parametrize("n,shortcut,cin,cout,H,W", SHAPES)
def test_plain_csplayer_matches_flax_and_pallas(n, shortcut, cin, cout, H, W):
    layer, v, tl, x = _pair(n, shortcut, cin, cout, H, W)
    want = np.asarray(layer.apply(v, jnp.asarray(x), train=False))
    fused = np.asarray(jfused(v, jnp.asarray(x), n=n, shortcut=shortcut,
                              out_features=cout, dtype=jnp.float32,
                              interpret=True))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = tl(xt).permute(0, 2, 3, 1).numpy()
        # the kernel's wrapper takes the plain layer for a CPU tensor
        via_wrapper = K3.fused_csplayer(tl, xt).permute(0, 2, 3, 1).numpy()
        packed = _kernel_math(torch.from_numpy(x),
                              K3.pack_csplayer(tl, torch.float32), shortcut)
    assert _rel(got, want) < 1e-4
    assert _rel(got, fused) < 1e-4
    np.testing.assert_array_equal(via_wrapper, got)
    # packed weights reproduce the Pallas kernel: same rounding points
    assert _rel(packed.numpy(), fused) < 1e-5


def test_fold_convbn_exact():
    layer = JConv(24, kernel=3, dtype=jnp.float32)
    x = np.random.default_rng(2).normal(size=(1, 8, 8, 16)).astype(np.float32)
    v = _realistic_variables(layer, jnp.asarray(x), seed=7)
    tm = ConvBnAct(16, 24, 3).eval()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    w, b = K3.fold_convbn(tm)
    jw, jb = jfold(v["params"], v["batch_stats"])
    np.testing.assert_allclose(w.detach().permute(2, 3, 1, 0).numpy(),
                               np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb),
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        folded = F.silu(F.conv2d(xt, w, b, padding=1))
        np.testing.assert_allclose(folded.numpy(), tm(xt).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiles_fit_yolox_s_shapes(dtype):
    """Every YOLOX-s 640 CSPLayer gets a tile whose haloed buffers fit in
    shared memory, and a whole number of tiles per frame."""
    item = torch.empty((), dtype=dtype).element_size()
    for HW, n, ch in [(80, 3, 64), (40, 3, 128), (20, 1, 256), (40, 1, 128),
                      (80, 1, 64)]:
        ts = K3.choose_tile(HW, HW, n, ch, item)
        assert 2 * (ts + 2 * n) ** 2 * ch * item <= K3.SMEM_LIMIT
        assert HW % ts == 0 and ts >= 4


def test_csplayer_cpu_dispatch_is_plain():
    """On CPU tensors CSPLayer.forward never reaches the kernel."""
    tl = CSPLayer(16, 16, 1).eval()
    before = K3.fused_csplayer.launches
    with torch.no_grad():
        x = torch.randn(1, 16, 8, 8)
        torch.testing.assert_close(tl(x), tl.forward_plain(x))
    assert K3.fused_csplayer.launches == before
