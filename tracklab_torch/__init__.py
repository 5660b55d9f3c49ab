"""tracklab_torch: the PyTorch/CUDA port of tracklab_tpu.

The package mirrors ``tracklab_tpu``'s module names, so each module has an
obvious counterpart there, and keeps its public layouts (NHWC uint8
frames, (D, 4) ltrb boxes, int32 ids). It imports torch and numpy only.
Hand-written Hopper kernels live under ``kernels/`` (sources in
``csrc/``) and are built with ``nvcc`` at first use, so importing the
package needs neither a GPU nor a CUDA compiler.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from tracklab_torch.device import resolve_device

__all__ = ["resolve_device"]
