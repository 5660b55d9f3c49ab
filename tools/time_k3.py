"""Time kernel K3 (the fused CSPLayer) of one checkout on the card.

Runs the seven dense CSPLayers of YOLOX-s at 640 x 640 (dark3 .. C3_n4,
the shapes chip_smoke.py's phase 4 times) through ``fused_csplayer`` of the
checkout at ``--root`` (default: the one holding this script), with seeded
weights (YOLOX's initialisation: lecun-normal convs, identity BN) and
seeded inputs, by that checkout's planner or, with ``--staged``, by the
staged route. Prints one JSON line: each layer's ms (CUDA events, the mean
of ``--reps`` calls after two), its largest difference from the plain layer
relative to max(|plain|, 1), their sum, and the card's name and power
limit. Two commits compare on one card when one command runs both, in the
order parent, change, change, parent:

    python tools/time_k3.py --root ../parent --dtype bf16 --batch 128
    python tools/time_k3.py --dtype bf16 --batch 128

Each checkout builds its own ``csrc/csp.cu`` under its ``build/``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

# (name, H = W, cin, cout, n, shortcut)
LAYERS = [("dark3", 80, 128, 128, 3, True),
          ("dark4", 40, 256, 256, 3, True),
          ("dark5", 20, 512, 512, 1, False),
          ("C3_p4", 40, 512, 256, 1, False),
          ("C3_p3", 80, 256, 128, 1, False),
          ("C3_n3", 40, 256, 256, 1, False),
          ("C3_n4", 20, 512, 512, 1, False)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--staged", action="store_true")
    args = ap.parse_args()

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_k3: no CUDA device", file=sys.stderr)
        return 2
    import tracklab_torch
    from tracklab_torch.kernels import _build
    from tracklab_torch.kernels import csp
    from tracklab_torch.models.yolox import CSPLayer

    if Path(tracklab_torch.__file__).resolve().parents[1] != root:
        print(f"time_k3: imported {tracklab_torch.__file__}, not {root}",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("csp",))
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    choose_tile = csp.choose_tile
    layers, total = {}, 0.0
    for i, (name, hw, cin, cout, n, sc) in enumerate(LAYERS):
        layer = CSPLayer(cin, cout, n, sc, dtype=dtype).eval()
        g = torch.Generator().manual_seed(i)
        with torch.no_grad():
            for key, t in layer.state_dict().items():
                if t.dim() == 4:
                    t.copy_(torch.randn(t.shape, generator=g)
                            / math.sqrt(t[0].numel()))
                elif key.endswith(("running_var", "bn.weight")):
                    t.fill_(1.0)
                else:
                    t.zero_()
        layer = layer.to(dev)
        x = torch.randn(args.batch, cin, hw, hw, generator=g).to(
            dev, dtype).contiguous(memory_format=torch.channels_last)
        if args.staged:
            csp.choose_tile = lambda *a, hw=hw: (hw, hw, csp.STAGED)
        try:
            with torch.no_grad():
                got = csp.fused_csplayer(layer, x)
                want = layer.forward_plain(x).float()
                rel = ((got.float() - want).abs()
                       / want.abs().clamp(min=1.0)).max().item()
                del got, want
                for _ in range(2):
                    csp.fused_csplayer(layer, x)
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                for _ in range(args.reps):
                    csp.fused_csplayer(layer, x)
                e.record()
                torch.cuda.synchronize()
        finally:
            csp.choose_tile = choose_tile
        ms = s.elapsed_time(e) / args.reps
        plan = (hw, hw, csp.STAGED) if args.staged else choose_tile(
            hw, hw, n, cin, cout // 2, cout, dtype)
        layers[name] = dict(ms=ms, rel=rel, plan=list(plan))
        total += ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(root=str(root), dtype=args.dtype, batch=args.batch,
                          staged=args.staged, reps=args.reps, layers=layers,
                          total_ms=total, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
