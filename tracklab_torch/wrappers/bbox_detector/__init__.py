from tracklab_torch.wrappers.bbox_detector.yolox_api import (  # noqa
    YOLOXDetector, letterbox,
)
from tracklab_torch.wrappers.bbox_detector.yolov8_api import (  # noqa
    YOLOv8Detector,
)
