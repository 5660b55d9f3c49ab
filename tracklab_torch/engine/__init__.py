"""The port's engines: the offline tracking engine and the fused
detect -> track programs (``engine/fused.py``)."""
from tracklab_torch.engine.engine import (  # noqa
    TrackingEngine, merge_dataframes,
)
from tracklab_torch.engine.offline import OfflineTrackingEngine  # noqa
