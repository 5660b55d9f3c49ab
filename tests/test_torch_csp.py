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
from tracklab_torch.models.yolox import (CSP_MAX_PIXELS, YOLOX_VARIANTS,
                                         CSPLayer, ConvBnAct, _round_depth,
                                         _round_width)

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

SHAPES = [(1, True, 64, 64, 16, 24), (3, True, 128, 128, 8, 8),
          (1, False, 96, 64, 8, 16)]


def _kernel_math(x, p, shortcut):
    """K3's arithmetic in plain torch on NHWC x and pack_csplayer output
    (weights K-contiguous, [out, in], in both types): f32 products,
    storage-type rounding after each SiLU."""
    B, H, W, cin = x.shape
    dt = p["wm"].dtype
    mm = lambda a, w: a.float() @ w.float().t()  # noqa
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


def _yolox_csplayers(variant, size):
    """(name, H=W, cin, ch, cout, n) of every dense CSPLayer of a YOLOX
    variant at ``size`` x ``size`` that K3's 80 x 80 rule admits."""
    v = YOLOX_VARIANTS[variant]
    w = lambda c: _round_width(c, v["width_mult"])      # noqa: E731
    d = lambda n: _round_depth(n, v["depth_mult"])      # noqa: E731
    layers = [("dark2", 4, w(128), w(128), d(3)),
              ("dark3", 8, w(256), w(256), d(9)),
              ("dark4", 16, w(512), w(512), d(9)),
              ("dark5", 32, w(1024), w(1024), d(3)),
              ("C3_p4", 16, w(1024), w(512), d(3)),
              ("C3_p3", 8, w(512), w(256), d(3)),
              ("C3_n3", 16, w(512), w(512), d(3)),
              ("C3_n4", 32, w(1024), w(1024), d(3))]
    return [(name, size // stride, cin, cout // 2, cout, n)
            for name, stride, cin, cout, n in layers
            if (size // stride) ** 2 <= CSP_MAX_PIXELS]


def _check_plan(H, n, cin, ch, cout, dtype):
    """choose_tile's plan: in f32 the staged route (None here); in bf16 the
    staged route (None) exactly where even one output pixel's haloed
    region is too large with either ring, else a tile that fits in shared
    memory and covers the frame, with the wide ring wherever a tile fits
    with it."""
    plan = K3.choose_tile(H, H, n, cin, ch, cout, dtype)
    one_pixel = [K3.smem_bytes(1, 1, n, ch, r) for r in (0, 1)]
    if dtype == torch.float32 or min(one_pixel) > K3.SMEM_LIMIT:
        assert plan == (H, H, K3.STAGED)
        return None
    th, tw, ring = plan
    assert 1 <= th <= H and 1 <= tw <= H
    assert K3.smem_bytes(th, tw, n, ch, ring) <= K3.SMEM_LIMIT
    assert ring == (0 if one_pixel[0] <= K3.SMEM_LIMIT else 1)
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiles_fit_yolox_s_shapes(dtype):
    """Every YOLOX-s 640 CSPLayer gets a plan. bf16: a tile whose haloed
    buffers (rows padded) and wide cp.async ring fit in shared memory, and
    the planner weighs the halo: tiles of at least 10 x 10. f32: the staged
    route (its haloed buffers take twice the bytes; the tiles that fit lost
    to the staged route at all seven layers on the card)."""
    for name, H, cin, ch, cout, n in _yolox_csplayers("s", 640):
        plan = _check_plan(H, n, cin, ch, cout, dtype)
        if dtype == torch.float32:
            assert plan is None, name
        else:
            th, tw, ring = plan
            assert ring == 0 and min(th, tw) >= 10, (name, th, tw)


# the bf16 layers no tile fits, even one output pixel with the compact ring:
# K3 runs them by the staged route, as it runs every f32 layer
NO_PLAN = {("l", "dark4"), ("x", "dark3"), ("x", "dark4")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("variant,size,layer", [
    (v, s, layer[0]) for v in ("tiny", "s", "m", "l", "x")
    for s in (640, 416) for layer in _yolox_csplayers(v, s)])
def test_tiles_fit_yolox_csplayers(variant, size, layer, dtype):
    """Each dense CSPLayer of YOLOX tiny..x at 640 and 416 gets a plan: in
    bf16 a tile plan that fits, but for those of NO_PLAN, whose one-pixel
    haloed region already exceeds shared memory, the staged route; in f32
    the staged route."""
    name, H, cin, ch, cout, n = next(
        t for t in _yolox_csplayers(variant, size) if t[0] == layer)
    plan = _check_plan(H, n, cin, ch, cout, dtype)
    assert (plan is None) == (dtype == torch.float32
                              or (variant, layer) in NO_PLAN)
    # every dense YOLOX layer takes its type's tensor-core kernel
    assert K3.route(dtype, cin, ch, cout) == (
        "tl_csp_bf16_mma" if dtype == torch.bfloat16 else "tl_csp_f32")


def test_route_by_dtype_and_channels():
    """bf16 runs the bf16 kernel, f32 the 3xTF32 one (both on the tensor
    cores); a shape the chosen kernel does not take raises, with no
    fallback."""
    assert K3.route(torch.bfloat16, 128, 64, 128) == "tl_csp_bf16_mma"
    assert K3.route(torch.float32, 128, 64, 128) == "tl_csp_f32"
    assert K3.route(torch.float32, 12, 20, 36) == "tl_csp_f32"
    for cin, ch, cout in [(12, 16, 32), (16, 20, 40), (16, 16, 36)]:
        with pytest.raises(ValueError):
            K3.route(torch.bfloat16, cin, ch, cout)
    with pytest.raises(ValueError):
        K3.route(torch.float32, 16, 6, 12)
    with pytest.raises(TypeError):
        K3.route(torch.float16, 16, 16, 32)


def test_yolox_l_dark3_takes_the_compact_ring():
    """YOLOX-l dark3 (ch 128, n 9) leaves no room for the wide ring in bf16
    at any tile; the compact ring still fits tiles of 4 output pixels. In
    f32 no tile fits and the layer takes the staged route."""
    for H in (80, 52):
        th, tw, ring = K3.choose_tile(H, H, 9, 256, 128, 256, torch.bfloat16)
        assert ring == 1 and th * tw >= 4, (th, tw)
    assert K3.choose_tile(80, 80, 9, 256, 128, 256,
                          torch.float32) == (80, 80, K3.STAGED)


def test_packing_is_k_contiguous():
    """pack_csplayer lays every weight out [out, in] in both types (the B
    operand's K axis contiguous), the 3x3 as (n, tap, out, in) with tap
    dy * 3 + dx: the bf16 packing is the f32 packing (held against the
    Pallas kernel above) rounded."""
    tl = CSPLayer(24, 32, 2).eval()
    p = K3.pack_csplayer(tl, torch.bfloat16)
    p32 = K3.pack_csplayer(tl, torch.float32)
    assert p["wm"].shape == (16, 24) and p["ws"].shape == (16, 24)
    assert p["w1"].shape == (2, 16, 16) and p["wf"].shape == (32, 32)
    assert p["w3"].shape == (2, 9, 16, 16)
    assert all(p[k].is_contiguous() and p[k].dtype == torch.bfloat16
               for k in ("wm", "ws", "w1", "w3", "wf"))
    w3, _ = K3.fold_convbn(tl.m[1].conv2)
    torch.testing.assert_close(p["w3"][1, 1 * 3 + 2].float(),
                               w3[:, :, 1, 2].to(torch.bfloat16).float())
    assert p32["wm"].shape == (16, 24) and p32["wf"].shape == (32, 32)
    for k in ("wm", "ws", "w1", "w3", "wf"):
        assert p32[k].is_contiguous() and p32[k].dtype == torch.float32
        assert torch.equal(p[k], p32[k].to(torch.bfloat16))


def test_csplayer_cpu_dispatch_is_plain():
    """On CPU tensors CSPLayer.forward never reaches the kernel."""
    tl = CSPLayer(16, 16, 1).eval()
    before = K3.fused_csplayer.launches
    with torch.no_grad():
        x = torch.randn(1, 16, 8, 8)
        torch.testing.assert_close(tl(x), tl.forward_plain(x))
    assert K3.fused_csplayer.launches == before
