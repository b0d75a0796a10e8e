"""Data parallelism over ``torch.distributed`` (port of
``robust_pose_tpu/parallel``)."""
