"""Multi-device parallelism of the port: one process per card over a
``torch.distributed`` process group (``mesh.py``), the fused programs
over many videos (``fused_mesh.py``) and one video's time axis
(``time_shard.py``)."""
from tracklab_torch.parallel.mesh import (  # noqa
    make_mesh, shard_params_tp, shard_batch_dp, tracker_videos_sharded,
)
