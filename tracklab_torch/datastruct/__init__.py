from tracklab_torch.datastruct.tracking_dataset import (  # noqa
    TrackingDataset, TrackingSet, SetsDict,
)
from tracklab_torch.datastruct.tracker_state import TrackerState  # noqa
from tracklab_torch.datastruct.datapipe import (  # noqa
    EngineDatapipe, PrefetchLoader,
)
