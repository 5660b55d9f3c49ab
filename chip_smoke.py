"""Drive tracklab_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from tracklab_torch/csrc (one nvcc per source);
  2. K1 (JV assignment) against its plain version: identical col2row on
     random and tie-heavy costs, and a batched launch with mixed
     k_eff/active;
  3. K3 (fused CSPLayer) against the plain layer at the seven YOLOX-s 640
     shapes, batch 8: f32 rel <= 1e-4 (TF32 off); bf16 rel <= 3e-2 and no
     farther from f32 than the plain bf16 layer; then timed at batch 128;
  4. OC-SORT on the card (through K1) against OC-SORT on the CPU on a
     200-frame, 20-object stream, id for id;
  5. the main path: YOLOX-s 640 bf16 (seeded random weights) -> NMS ->
     OC-SORT over 4 chunks of 128 quasi-static uint8 frames, with the
     kernels' launch counters read around it.

The last three lines are the card's name and power limit, a JSON line with
each kernel's check and times, and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from functools import partial

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK = {"bf16": 989e12, "f32": 67e12}


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound_ms(nbytes, ops, peak):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / peak * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------- phase 2: K1
def phase_k1(torch, dev):
    from tracklab_torch.kernels import jv
    from tracklab_torch.ops.assignment import _forced_prep

    g = torch.Generator(device="cpu").manual_seed(0)
    cases = [(f"random K={k}", torch.randn(k, k, generator=g))
             for k in (32, 64, 128) for _ in range(2)]
    tie = torch.zeros(64, 64)
    tie[:5, :4] = -2.0
    cases += [("tie blocks K=64", tie),
              ("integer ties K=48", torch.randint(0, 3, (48, 48),
                                                  generator=g).float())]
    one = lambda k: torch.tensor([k], dtype=torch.int32, device=dev)  # noqa
    on = torch.ones(1, dtype=torch.bool, device=dev)
    for name, c in cases:
        c = c.to(dev)
        got = jv.solve_square_batched(c[None], one(c.shape[0]), on)[0]
        want = jv._solve_square_plain(c)
        check(torch.equal(got, want), f"K1 {name}: col2row differs")
    log(f"K1: {len(cases)} problems identical to the plain version")

    S = 64
    c = torch.randn(6, S, S, generator=g).to(dev)
    k_eff = torch.tensor([64, 32, 17, 64, 1, 40], dtype=torch.int32,
                         device=dev)
    act = torch.tensor([1, 1, 1, 0, 1, 1], dtype=torch.bool, device=dev)
    got = jv.solve_square_batched(c, k_eff, act)
    want = jv.solve_square_batched_plain(c, k_eff.cpu(), act.cpu()).to(dev)
    check(torch.equal(got, want), "K1 batched mixed k_eff/active differs")
    log("K1: batched launch with mixed k_eff/active identical")

    # a main-path problem: 32 detection rows x 64 track columns,
    # forced-matching square (matching_forced's full branch)
    cost = -torch.rand(32, 64, generator=g)
    rm = torch.rand(32, generator=g) < 0.75
    cm = torch.rand(64, generator=g) < 0.65
    sq, _ = _forced_prep(cost, rm, cm)
    sq = sq.to(dev)
    stats = {}
    want = jv._solve_square_plain(sq, stats)
    kk = one(S)
    got = jv.solve_square_batched(sq[None], kk, on)[0]
    check(torch.equal(got, want), "K1 main-path problem differs")
    ms = cuda_ms(lambda: jv.solve_square_batched(sq[None], kk, on), 200)
    plain_ms = cuda_ms(lambda: jv._solve_square_plain(sq), 2, warmup=1)
    # each shortest-path step: ~6 f32 ops per column (2 sub, cmp, select,
    # argmin, dual update)
    ops = stats["steps"] * 6 * S
    b_ms, b_by = bound_ms(S * S * 4 + S * 4 + 5, ops, PEAK["f32"])
    log(f"K1 timing at S=64: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}), {stats['steps']} path steps")
    return dict(name="K1 jv_solve_batched", route="cuda",
                source="tracklab_torch/csrc/jv.cu",
                replaces="tracklab_tpu/ops/assignment_pallas.py:146",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# ---------------------------------------------------------------- phase 3: K3
# (name, H=W, cin, cout, n, shortcut) of YOLOX-s at 640x640
CSP_SHAPES = [("dark3__1", 80, 128, 128, 3, True),
              ("dark4__1", 40, 256, 256, 3, True),
              ("dark5__2", 20, 512, 512, 1, False),
              ("C3_p4", 40, 512, 256, 1, False),
              ("C3_p3", 80, 256, 128, 1, False),
              ("C3_n3", 40, 256, 256, 1, False),
              ("C3_n4", 20, 512, 512, 1, False)]


def _seeded_csp(torch, cin, cout, n, shortcut, dtype, dev, seed, realistic):
    """A CSPLayer with seeded weights. ``realistic``: gain-1.5 convs and
    positive random BN statistics (the regime of trained checkpoints);
    otherwise the main path's initialisation (YOLOX.randomize_: lecun-normal
    convs, identity BN)."""
    from tracklab_torch.models.yolox import CSPLayer

    layer = CSPLayer(cin, cout, n, shortcut, dtype=dtype).eval()
    g = torch.Generator().manual_seed(seed)
    gain = 1.5 if realistic else 1.0
    with torch.no_grad():
        for name, t in layer.state_dict().items():
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        * (gain / math.sqrt(t[0].numel())))
            elif realistic:
                t.copy_(torch.randn(t.shape, generator=g).abs() * 0.3 + 0.5)
            elif name.endswith(("running_var", "bn.weight")):
                t.fill_(1.0)
            else:
                t.zero_()
    return layer.to(dev)


def _rel(got, want):
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1.0)).max().item()


def phase_k3(torch, dev, time_batch):
    """f32: realistic weights, rel <= 1e-4 against the plain layer. bf16:
    the main path's weights, rel <= 3e-2 against the plain bf16 layer, and
    no farther from the f32 plain layer than the plain bf16 layer is (x1.5).
    bf16 rounding compounds through the bottleneck chain, so how far two
    bf16 orders of rounding drift apart depends on the weights' gain."""
    from tracklab_torch.kernels.csp import fused_csplayer

    worst = {"f32": 0.0, "bf16": 0.0}
    max_abs = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0)
    for i, (name, hw, cin, cout, n, sc) in enumerate(CSP_SHAPES):
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(8, cin, hw, hw, generator=g).to(dev).contiguous(
            memory_format=torch.channels_last)
        mk = partial(_seeded_csp, torch, cin, cout, n, sc, dev=dev, seed=i)
        l32 = mk(torch.float32, realistic=True)
        m32 = mk(torch.float32, realistic=False)
        m16 = mk(torch.bfloat16, realistic=False)
        with torch.no_grad():
            got32, want32 = fused_csplayer(l32, x), l32.forward_plain(x)
            x16 = x.to(torch.bfloat16)
            got16, want16 = fused_csplayer(m16, x16), m16.forward_plain(x16)
            truth = m32.forward_plain(x)
        torch.cuda.synchronize()
        check(got32.shape == want32.shape == got16.shape, f"K3 {name}: shape")
        r32, r16 = _rel(got32, want32), _rel(got16, want16)
        k_truth, p_truth = _rel(got16, truth), _rel(want16, truth)
        err = (got16.float() - want16.float()).abs()
        log(f"K3 {name}: f32 rel {r32:.3e} (tol 1e-4); bf16 rel {r16:.3e} "
            f"(tol 3e-2), max abs {err.max().item():.3e}, mean abs "
            f"{err.mean().item():.3e}; vs f32: kernel {k_truth:.3e}, plain "
            f"bf16 {p_truth:.3e}")
        check(r32 <= 1e-4, f"K3 {name} f32: rel {r32} > 1e-4")
        check(r16 <= 3e-2, f"K3 {name} bf16: rel {r16} > 3e-2")
        check(k_truth <= 1.5 * p_truth,
              f"K3 {name} bf16: {k_truth} from f32, plain bf16 {p_truth}")
        worst["f32"] = max(worst["f32"], r32)
        worst["bf16"] = max(worst["bf16"], r16)
        max_abs = max(max_abs, err.max().item())

        # time at the main path's batch
        xb = torch.randn(time_batch, cin, hw, hw, generator=g).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            k_ms = cuda_ms(lambda: fused_csplayer(m16, xb), 3)
            p_ms = cuda_ms(lambda: m16.forward_plain(xb), 3)
        ch = cout // 2
        flops = 2 * hw * hw * ch * (2 * cin + 10 * n * ch + 2 * cout)
        tot["ms"] += k_ms
        tot["plain_ms"] += p_ms
        tot["flops"] += flops * time_batch
        tot["bytes"] += time_batch * hw * hw * (cin + cout) * 2
        log(f"K3 {name} bf16 batch {time_batch}: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, "
            f"{flops * time_batch / k_ms / 1e9:.1f} TFLOP/s")
    b_ms, b_by = bound_ms(tot["bytes"], tot["flops"], PEAK["bf16"])
    log(f"K3 all seven layers, bf16 batch {time_batch}: kernel "
        f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); worst rel f32 {worst['f32']:.3e}, "
        f"bf16 {worst['bf16']:.3e}")
    return dict(name="K3 csp_fused", route="cuda",
                source="tracklab_torch/csrc/csp.cu",
                replaces="tracklab_tpu/ops/csp_pallas.py:130",
                max_abs_err=max_abs, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ----------------------------------------------------------- phase 4: tracker
def synth_stream(seed, n_frames=200, n_obj=20, drop=0.15, fp_rate=0.5,
                 img=(1920, 1080)):
    """Linear-motion objects with noisy detections, dropouts and false
    positives; per frame an (N, 7) array [ltrb, conf, cls, ref]."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([100, 100], [img[0] - 300, img[1] - 300], (n_obj, 2))
    vel = rng.uniform(-8, 8, (n_obj, 2))
    size = rng.uniform(40, 160, (n_obj, 2))
    frames, ref = [], 0
    for _ in range(n_frames):
        rows = []
        pos = pos + vel
        for k in range(n_obj):
            if rng.uniform() < drop:
                continue
            c = pos[k] + rng.normal(0, 2, 2)
            s = size[k] * rng.uniform(0.95, 1.05, 2)
            rows.append([c[0], c[1], c[0] + s[0], c[1] + s[1],
                         rng.uniform(0.2, 1.0), 1.0, ref])
            ref += 1
        for _ in range(rng.poisson(fp_rate)):
            c = rng.uniform([0, 0], [img[0] - 200, img[1] - 200])
            s = rng.uniform(30, 120, 2)
            rows.append([c[0], c[1], c[0] + s[0], c[1] + s[1],
                         rng.uniform(0.15, 0.9), 1.0, ref])
            ref += 1
        frames.append(np.array(rows, np.float64).reshape(-1, 7))
    return frames


def phase_tracker(torch, dev):
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.trackers.common import Detections, pad_detections
    from tracklab_torch.trackers.ocsort import OCSortConfig, ocsort_scan

    cfg = OCSortConfig(max_tracks=64, max_dets=32, det_thresh=0.45,
                       max_age=12, min_hits=2, iou_threshold=0.25)
    frames = synth_stream(0)
    per = [pad_detections(f[:, :4], f[:, 4], f[:, 5], f[:, 6].astype(int),
                          capacity=32, device="cpu") for f in frames]
    dets = Detections(*(torch.stack(x) for x in zip(*per)))
    before = solve_square_batched.launches
    t0 = time.perf_counter()
    _, out_g = ocsort_scan(cfg, Detections(*(x.to(dev) for x in dets)))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, out_c = ocsort_scan(cfg, dets)
    t_cpu = time.perf_counter() - t0
    check(solve_square_batched.launches > before, "tracker never ran K1")
    check(torch.equal(out_g.valid.cpu(), out_c.valid),
          "tracker valid differs between cuda and cpu")
    v = out_c.valid
    check(torch.equal(out_g.track_id.cpu()[v], out_c.track_id[v]),
          "tracker ids differ between cuda and cpu")
    d = (out_g.ltrb.cpu()[v] - out_c.ltrb[v]).abs().max().item()
    check(d < 1e-3, f"tracker boxes differ by {d}")
    log(f"tracker: {len(frames)} frames, {int(v.sum())} emitted boxes, ids "
        f"identical cuda vs cpu (max box diff {d:.2e}); "
        f"{solve_square_batched.launches - before} K1 launches; "
        f"{t_gpu / len(frames) * 1e3:.2f} ms/frame on cuda, "
        f"{t_cpu / len(frames) * 1e3:.2f} ms/frame on cpu")


# -------------------------------------------------------- phase 5: main path
def profile_window(torch, fn, n_frames):
    """Run ``fn`` under torch.profiler: host ms, device-busy ms (sum of
    kernel times) and kernel launches, each per frame, and the device's
    idle share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    return dict(host_ms_per_frame=wall_ms / n_frames,
                device_ms_per_frame=busy_us / 1e3 / n_frames,
                launches_per_frame=launches / n_frames,
                device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
                top_kernels_ms_per_frame=[
                    (e.key[:72], e.self_device_time_total / 1e3 / n_frames)
                    for e in kernels[:4]])


def phase_main(torch, dev, n_chunks=4, chunk=128, size=640):
    from tracklab_torch.engine.fused import (fused_detect_track,
                                             make_yolox_detect_fn)
    from tracklab_torch.kernels.csp import fused_csplayer
    from tracklab_torch.kernels.jv import solve_square_batched
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.common import Detections
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_step)

    cfg = OCSortConfig(max_tracks=64, max_dets=32, min_hits=1)
    model = YOLOX(num_classes=1, variant="s", dtype=torch.bfloat16,
                  device=dev).randomize_(0)
    F = n_chunks * chunk
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randint(0, 235, (1, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    noise = torch.randint(0, 20, (F, size, size, 3), generator=g,
                          device=dev, dtype=torch.uint8)
    video = base + noise
    del noise

    # calibrate the score threshold to ~20 detections on frame 0
    cal = make_yolox_detect_fn(model, conf_threshold=0.3, max_dets=32,
                               compute_dtype=torch.bfloat16)(video[:chunk])
    s = cal.conf[0][cal.valid[0]].sort(descending=True).values.cpu().numpy()
    conf = float(round((s[19] + s[20]) / 2, 6)) if s.size >= 21 else 0.3
    log(f"main path: calibrated conf {conf} ({s.size} NMS survivors on "
        "frame 0 at 0.3)")
    detect = make_yolox_detect_fn(model, conf_threshold=conf, max_dets=32,
                                  compute_dtype=torch.bfloat16)
    step = partial(ocsort_step, cfg)

    # warm-up on one chunk, counting host syncs
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused_detect_track(detect, step, ocsort_init(cfg, device=dev),
                           video[:chunk], chunk, return_detections=False)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    syncs_per_frame = syncs / chunk

    solve_square_batched.launches = 0
    fused_csplayer.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, out = fused_detect_track(detect, step, ocsort_init(cfg, device=dev),
                                   video, chunk, return_detections=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"K1": solve_square_batched.launches,
                "K3": fused_csplayer.launches}
    fps = F / dt
    per_frame = out.valid.sum(1).float().mean().item()
    log(f"main path: {F} frames in {dt:.3f} s = {fps:.2f} frames/s, "
        f"{per_frame:.2f} tracks/frame, launches {launches}, "
        f"{syncs_per_frame:.3f} host syncs/frame (warm-up chunk)")
    check(launches["K3"] == 7 * n_chunks,
          f"K3 launches {launches['K3']} != 7 per chunk")
    check(launches["K1"] > 0, "K1 never launched on the main path")
    check(out.valid.any().item(), "tracker emitted no tracks")
    check(torch.isfinite(out.ltrb[out.valid]).all().item(),
          "non-finite track boxes")
    check(out.valid.shape == (F, cfg.max_tracks), "output shape")

    # where the time goes: the detector on one chunk, then 32 tracker steps
    # on its detections under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = detect(video[:chunk])
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3
    frames = [Detections(*(x[f] for x in dets)) for f in range(min(32, chunk))]
    init = ocsort_init(cfg, device=dev)

    def track():
        st = init
        for d in frames:
            st, _ = step(st, d)

    track()
    trk = profile_window(torch, track, len(frames))
    log(f"main path split: detector {det_ms:.1f} ms per chunk of {chunk} "
        f"({det_ms / chunk:.3f} ms/frame); tracker {trk}")
    return launches, dict(fps=fps, syncs_per_frame=syncs_per_frame,
                          tracks_per_frame=per_frame,
                          detector_ms_per_frame=det_ms / chunk,
                          tracker=trk)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from tracklab_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    k1 = phase_k1(torch, dev)
    k3 = phase_k3(torch, dev, time_batch=128)
    phase_tracker(torch, dev)
    launches, main_stats = phase_main(torch, dev)
    k1["launches"], k3["launches"] = launches["K1"], launches["K3"]

    print(json.dumps({"main_path": main_stats}))
    print(smi)
    print(json.dumps({"kernels": [k1, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
