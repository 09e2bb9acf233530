"""lidarslam_tpu_torch — the LiDAR SLAM engine on PyTorch and CUDA.

A port of `lidarslam_tpu` (JAX) for NVIDIA Hopper: plain tensor code is
PyTorch, and the map k-NN that the JAX package writes in Pallas for the TPU
is a CUDA kernel written by hand (`csrc/knn.cu`, built at first use).
This package never imports jax.

    from lidarslam_tpu_torch import Slam, SlamConfig
    slam = Slam(SlamConfig())               # on the GPU; device="cpu" for the CPU
    result = slam.add_frame(sweep)          # or: add_frame_async(...), flush()
    result = slam.add_frames(acquisition)   # a multi-LiDAR rig, one frame per device
"""

from lidarslam_tpu_torch.config import SlamConfig
from lidarslam_tpu_torch.slam import Slam

__version__ = "0.1.0"   # the JAX package's

__all__ = ["Slam", "SlamConfig", "__version__"]
