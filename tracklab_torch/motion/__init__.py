"""Global (camera) motion estimation (counterpart of tracklab_tpu.motion):
the dense pyramidal Lucas-Kanade estimator on the device (``lk``) and the
host ``GMC`` estimator (``gmc``)."""
