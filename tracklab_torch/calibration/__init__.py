from tracklab_torch.calibration.camera import (  # noqa
    CameraParams, project_points, backproject_to_pitch, camera_matrix,
)
from tracklab_torch.calibration.pitch import pitch_segments  # noqa
from tracklab_torch.calibration.tvcalib import (  # noqa
    optimize_cameras, TVCalibConfig,
)
