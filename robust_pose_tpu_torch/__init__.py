"""PyTorch + CUDA port of robust_pose_tpu for NVIDIA Hopper (H100).

Frame-to-frame streaming tracking (``slam.pose_estimator.PoseEstimator``)
runs end to end: RAFT flow with a hand-written correlation-lookup kernel
(``ops/corr_onthefly.py``, CUDA C++) and instance-norm kernel (statistics,
normalize and ReLU in one call; ``ops/instance_norm.py``, CUDA C++),
TinyUNet confidence heads, and the
Levenberg-Marquardt pose solve, one hand-written kernel launch a solve
with the normal-equation builds inside (``ops/normal_eq.py``, CUDA C++).

Public functions keep the JAX package's NHWC / points-last layouts. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on a CPU
tensor every kernel wrapper uses its plain PyTorch version.
"""
