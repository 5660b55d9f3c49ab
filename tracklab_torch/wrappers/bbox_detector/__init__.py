from tracklab_torch.wrappers.bbox_detector.yolox_api import (  # noqa
    YOLOXDetector, letterbox,
)
from tracklab_torch.wrappers.bbox_detector.yolov8_api import (  # noqa
    YOLOv8Detector,
)
from tracklab_torch.wrappers.bbox_detector.rtdetr_api import (  # noqa
    RTDETRDetector,
)
from tracklab_torch.wrappers.bbox_detector.rtmdet_api import (  # noqa
    RTMDetDetector,
)
