"""Import guard for the port: tracklab_torch and chip_smoke.py import
nothing of JAX or of the JAX package, and import without triton, nvcc or a
GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "tracklab_tpu")
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "tracklab_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imports(tree) if m.split(".")[0] in BANNED]
    assert not bad, f"{rel} imports {bad}"


_PROBE = r"""
import importlib, pkgutil, sys
BLOCK = {"jax", "jaxlib", "flax", "optax", "tracklab_tpu", "triton"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCK:
        del sys.modules[name]

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import tracklab_torch
names = [m.name for m in pkgutil.walk_packages(tracklab_torch.__path__,
                                               "tracklab_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCK)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_in_a_clean_interpreter():
    """A fresh interpreter that blocks JAX, the JAX package and triton, with
    no CUDA toolkit on PATH, imports every module of the port."""
    env = dict(os.environ, CUDA_HOME=str(ROOT / "no-cuda-here"),
               PATH=os.path.dirname(sys.executable),
               PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 35


# modules of the ReID slice, the ORU replay kernels, the Deep-OC-SORT /
# BoT-SORT / camera-motion slice, the command line's host layers and its
# ReID wrappers and MOT-format datasets, the batched, pipelined and online
# engines with their datasets, callbacks and visualization, and the
# YOLOv8 / YOLO11 and game-state modules (calibration, pitch segmentation,
# jersey OCR, SoccerNet, GS-HOTA), and the pose modules (the pose models,
# ViTPose, the coordinate helpers, the pose wrappers and the keypoint
# prompt masks), and the KPR and PoseTrack modules (the KPR wrappers, the
# pandas accessors, the PoseTrack datasets and metrics), and the detector
# zoo and DeepLabV3 (RTMDet, both RT-DETR families, their converters and
# wrappers), which the checks above must cover
SLICE_MODULES = ("tracklab_torch/ops/embeddings.py",
                 "tracklab_torch/models/osnet.py",
                 "tracklab_torch/kernels/oru_replay.py",
                 "tracklab_torch/trackers/strongsort.py",
                 "tracklab_torch/trackers/deepocsort.py",
                 "tracklab_torch/trackers/botsort.py",
                 "tracklab_torch/motion/lk.py",
                 "tracklab_torch/motion/gmc.py",
                 "tracklab_torch/main.py",
                 "tracklab_torch/config/compose.py",
                 "tracklab_torch/config/plugins.py",
                 "tracklab_torch/pipeline/module.py",
                 "tracklab_torch/pipeline/levels.py",
                 "tracklab_torch/utils/collate.py",
                 "tracklab_torch/utils/parallel.py",
                 "tracklab_torch/utils/cv2.py",
                 "tracklab_torch/datastruct/tracking_dataset.py",
                 "tracklab_torch/datastruct/tracker_state.py",
                 "tracklab_torch/datastruct/datapipe.py",
                 "tracklab_torch/callbacks/callback.py",
                 "tracklab_torch/callbacks/progress.py",
                 "tracklab_torch/callbacks/timer.py",
                 "tracklab_torch/engine/engine.py",
                 "tracklab_torch/engine/offline.py",
                 "tracklab_torch/eval/metrics.py",
                 "tracklab_torch/eval/evaluator.py",
                 "tracklab_torch/wrappers/dataset/synthetic.py",
                 "tracklab_torch/wrappers/track/scan_tracker.py",
                 "tracklab_torch/wrappers/bbox_detector/yolox_api.py",
                 "tracklab_torch/wrappers/reid/__init__.py",
                 "tracklab_torch/wrappers/reid/osnet_api.py",
                 "tracklab_torch/wrappers/reid/batched_api.py",
                 "tracklab_torch/wrappers/dataset/mot_like.py",
                 "tracklab_torch/engine/fused.py",
                 "tracklab_torch/motion/__init__.py",
                 "tracklab_torch/engine/batched.py",
                 "tracklab_torch/engine/pipelined.py",
                 "tracklab_torch/engine/video.py",
                 "tracklab_torch/wrappers/dataset/external_video.py",
                 "tracklab_torch/wrappers/tracklet_agg/__init__.py",
                 "tracklab_torch/wrappers/tracklet_agg/majority_vote.py",
                 "tracklab_torch/callbacks/profiler.py",
                 "tracklab_torch/callbacks/handle_regions.py",
                 "tracklab_torch/visualization/__init__.py",
                 "tracklab_torch/visualization/image.py",
                 "tracklab_torch/visualization/detection.py",
                 "tracklab_torch/visualization/keypoints.py",
                 "tracklab_torch/visualization/tracking.py",
                 "tracklab_torch/visualization/visualizer.py",
                 "tracklab_torch/visualization/visualization_engine.py",
                 "tracklab_torch/utils/notebook.py",
                 "tracklab_torch/models/yolov8.py",
                 "tracklab_torch/models/yolo11.py",
                 "tracklab_torch/models/segmentation.py",
                 "tracklab_torch/wrappers/bbox_detector/yolov8_api.py",
                 "tracklab_torch/calibration/__init__.py",
                 "tracklab_torch/calibration/pitch.py",
                 "tracklab_torch/calibration/camera.py",
                 "tracklab_torch/calibration/cam_distr.py",
                 "tracklab_torch/calibration/tvcalib.py",
                 "tracklab_torch/wrappers/calibration_api.py",
                 "tracklab_torch/wrappers/jersey/__init__.py",
                 "tracklab_torch/wrappers/jersey/ocr_api.py",
                 "tracklab_torch/wrappers/dataset/soccernet.py",
                 "tracklab_torch/eval/gs_metrics.py",
                 "tracklab_torch/eval/gs_evaluator.py",
                 "tracklab_torch/models/pose.py",
                 "tracklab_torch/models/vitpose.py",
                 "tracklab_torch/utils/coordinates.py",
                 "tracklab_torch/wrappers/pose_estimator/__init__.py",
                 "tracklab_torch/wrappers/pose_estimator/bottomup_api.py",
                 "tracklab_torch/wrappers/pose_estimator/topdown_api.py",
                 "tracklab_torch/wrappers/pose_estimator/batched_api.py",
                 "tracklab_torch/wrappers/reid/reid_dataset.py",
                 "tracklab_torch/wrappers/reid/kpr_api.py",
                 "tracklab_torch/utils/__init__.py",
                 "tracklab_torch/utils/accessors.py",
                 "tracklab_torch/wrappers/dataset/posetrack.py",
                 "tracklab_torch/eval/pose_metrics.py",
                 "tracklab_torch/eval/pose_reid_metrics.py",
                 "tracklab_torch/eval/pose_evaluator.py",
                 "tracklab_torch/models/rtmdet.py",
                 "tracklab_torch/models/rtdetr.py",
                 "tracklab_torch/models/rtdetr_hf.py",
                 "tracklab_torch/models/deeplabv3.py",
                 "tracklab_torch/models/convert.py",
                 "tracklab_torch/wrappers/bbox_detector/rtmdet_api.py",
                 "tracklab_torch/wrappers/bbox_detector/rtdetr_api.py",
                 "tracklab_torch/wrappers/bbox_detector/__init__.py")


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_modules_are_checked(rel):
    assert rel in PORT_FILES
    test_port_file_imports_nothing_of_jax(rel)


_QUICK_START = r"""
import sys
BLOCK = {"jax", "jaxlib", "flax", "optax", "tracklab_tpu", "triton"}
sys.modules["cv2"] = None      # OpenCV absent: import cv2 raises


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import: " + name)
        return None


sys.meta_path.insert(0, Blocker())
import tracklab_torch.main as M
from tracklab_torch.utils.cv2 import cv2_load_image
parts, res = M.main(["device=cpu", "dataset.n_videos=1",
                     "dataset.n_frames=12", "dataset.n_objects=3",
                     "dataset.img_w=320", "dataset.img_h=240",
                     "state.load_from_groundtruth={detection: [bbox_ltwh, "
                     "bbox_conf, category_id]}",
                     "use_rich=false"])
assert res["COMBINED_SEQ"]["HOTA"] == 100.0, res["COMBINED_SEQ"]["HOTA"]
path = parts["tracker_state"].image_metadatas["file_path"].iloc[0]
assert cv2_load_image(path).shape == (240, 320, 3)
try:
    cv2_load_image("frame.jpg")
except ImportError as e:
    assert "cv2" in str(e), e
else:
    raise AssertionError("a file path loaded without OpenCV")
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCK)
assert not leaked, leaked
print("ok")
"""


def test_cli_quick_start_without_opencv_or_jax():
    """``tracklab_torch.main`` imports, and the synthetic quick start runs,
    in an interpreter where cv2, JAX and the JAX package cannot be
    imported; a file path then raises ImportError naming cv2."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _QUICK_START], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "ok"
