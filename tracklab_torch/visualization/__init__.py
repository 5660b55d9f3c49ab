from tracklab_torch.visualization.visualizer import (  # noqa
    Visualizer, ImageVisualizer, DetectionVisualizer, track_color,
)
from tracklab_torch.visualization.detection import (  # noqa
    DefaultDetectionVisualizer, EllipseDetectionVisualizer,
    DebugDetectionVisualizer,
)
from tracklab_torch.visualization.keypoints import (  # noqa
    KeypointsVisualizer,
)
from tracklab_torch.visualization.tracking import (  # noqa
    TrackingLineVisualizer,
)
from tracklab_torch.visualization.image import FrameCounterVisualizer  # noqa
from tracklab_torch.visualization.visualization_engine import (  # noqa
    VisualizationEngine,
)
from tracklab_torch.visualization.detection import (  # noqa
    DetectionStatsVisualizer, IgnoreRegionVisualizer,
)
