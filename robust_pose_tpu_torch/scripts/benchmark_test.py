"""Test-set benchmark CLI (port of ``scripts/benchmark_test.py``): the
trajectory-inference CLI over the frame ranges of ``test_split.csv``
(columns ``start`` and ``end``), each row's outputs in
``<outpath>/<row>``::

    python -m robust_pose_tpu_torch.scripts.benchmark_test <sequence> \\
        --checkpoint <dir or .pth> --outpath <dir> [--window 8] \\
        [--device {cuda,cpu}]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import os

from robust_pose_tpu_torch.scripts.benchmark_scenarios import build_parser, read_rows


def run_rows(args, config, rows, infer):
    """``infer(args, config)`` over each row: frames ``start`` to ``end``,
    outputs in ``<outpath>/<i>``, the config carrying ``start``, ``end``
    and ``seq_number``."""
    base_out = args.outpath
    for i, row in enumerate(rows):
        args.start = int(row["start"])
        args.stop = int(row["end"])
        if base_out is not None:
            args.outpath = os.path.join(base_out, f"{i}")
        config.update({"start": args.start, "end": args.stop, "seq_number": i})
        print(f"{args.start} -> {args.stop}")
        infer(args, config)


def main(argv=None):
    from robust_pose_tpu_torch.scripts.infer_trajectory import main as infer
    from robust_pose_tpu_torch.utils.config import read_yaml

    args = build_parser("script to benchmark pose estimation on the test "
                        "split").parse_args(argv)
    config = read_yaml(args.config)
    run_rows(args, config, read_rows(args, "test_split.csv"), infer)


if __name__ == "__main__":
    main()
