"""lidarslam_tpu_torch — the LiDAR SLAM engine on PyTorch and CUDA.

A port of `lidarslam_tpu` (JAX) for NVIDIA Hopper: plain tensor code is
PyTorch, and the map k-NN that the JAX package writes in Pallas for the TPU
is a CUDA kernel written by hand (`csrc/knn.cu`, built at first use).
This package never imports jax.

    from lidarslam_tpu_torch import Slam, SlamConfig
    slam = Slam(SlamConfig(), device="cuda")
    result = slam.add_frame(sweep)
"""

from lidarslam_tpu_torch.config import SlamConfig
from lidarslam_tpu_torch.slam import Slam

__all__ = ["Slam", "SlamConfig"]
