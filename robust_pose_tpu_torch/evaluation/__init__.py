"""Evaluation CLIs of the port: ATE/RPE of one trajectory
(``evaluate_ate_freiburg``), tables over a results tree
(``inspect_results``) and trajectory plots (``trajectory_plots``), each run
as ``python -m robust_pose_tpu_torch.evaluation.<name>``."""
