from tracklab_torch.wrappers.bbox_detector.yolox_api import (  # noqa
    YOLOXDetector, letterbox,
)
