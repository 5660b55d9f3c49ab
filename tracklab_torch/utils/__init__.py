"""Host utilities of the port: coordinates, pandas accessors, collate,
parallel map, image loading.

Importing this package registers the ``df.bbox`` / ``df.keypoints`` pandas
accessors (``utils/accessors.py``), as the JAX package's ``utils`` does.
"""
from tracklab_torch.utils import coordinates  # noqa: F401
from tracklab_torch.utils.accessors import (  # noqa: F401
    BBoxDataFrameAccessor, BBoxSeriesAccessor,
    KeypointsDataFrameAccessor, KeypointsSeriesAccessor,
)
