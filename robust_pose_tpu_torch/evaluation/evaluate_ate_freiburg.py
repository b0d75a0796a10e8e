"""ATE/RPE of one trajectory against its ground truth (port of
``evaluation/evaluate_ate_freiburg.py``)::

    python -m robust_pose_tpu_torch.evaluation.evaluate_ate_freiburg \\
        <groundtruth.txt> <trajectory.freiburg> [--delta 1] [--offset 0]

The implementation is ``robust_pose_tpu_torch.utils.evaluate``."""
from robust_pose_tpu_torch.utils.evaluate import main

if __name__ == "__main__":
    main()
