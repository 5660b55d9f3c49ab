"""The port's engines: offline, batched (many videos at once), online
(frame by frame) and pipelined, and the fused detect -> track programs
(``engine/fused.py``)."""
from tracklab_torch.engine.engine import (  # noqa
    TrackingEngine, merge_dataframes,
)
from tracklab_torch.engine.offline import OfflineTrackingEngine  # noqa
from tracklab_torch.engine.batched import BatchedOfflineTrackingEngine  # noqa
from tracklab_torch.engine.pipelined import PipelinedTrackingEngine  # noqa
from tracklab_torch.engine.video import VideoOnlineTrackingEngine  # noqa
