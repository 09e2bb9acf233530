"""The benchmark of lidarslam_tpu_torch on an NVIDIA GPU (see README.md)."""
