"""Scenario benchmark CLI (port of ``scripts/benchmark_scenarios.py``):
the trajectory-inference CLI over the frame ranges of ``scenarios.csv``
(breathing and tool-deformation scenarios; columns ``scenario``, ``start``
and ``end``), each range cut to 300 frames, each row's outputs in
``<outpath>/<row>``::

    python -m robust_pose_tpu_torch.scripts.benchmark_scenarios <sequence> \\
        --checkpoint <dir or .pth> --outpath <dir> [--window 8] \\
        [--device {cuda,cpu}]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import csv
import os

MAX_FRAMES = 300


def build_parser(description: str) -> argparse.ArgumentParser:
    """The options of both benchmark CLIs."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("input", type=str, help="Path to input folder.")
    parser.add_argument("--checkpoint", type=str,
                        default="../trained/poseNet_2xf8up4b.pth")
    parser.add_argument("--outpath", type=str)
    parser.add_argument("--config", type=str,
                        default=os.path.join(os.path.dirname(__file__), "..",
                                             "..", "configuration",
                                             "infer_f2f.yaml"))
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="device selection (default cuda; without a "
                        "card, cpu must be named).")
    parser.add_argument("--step", type=int, default=1)
    parser.add_argument("--log", default=None)
    parser.add_argument("--viewer", default="none", choices=["none", "2d"])
    parser.add_argument("--block_viewer", action="store_true")
    parser.add_argument("--window", type=int, default=1,
                        help="track N frames per batched pass (streaming)")
    parser.add_argument("--device-preproc", action="store_true",
                        dest="device_preproc",
                        help="on-device mask/resize/rectify (video datasets)")
    return parser


def read_rows(args, csv_name: str):
    """The rows of ``<input>/<csv_name>`` as dicts, after checking that the
    checkpoint and the file exist."""
    if not os.path.exists(args.checkpoint):
        raise FileNotFoundError(f"no valid checkpoint file: {args.checkpoint}")
    path = os.path.join(args.input, csv_name)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def run_rows(args, config, rows, infer):
    """``infer(args, config)`` over each scenario row: frames ``start`` to
    ``min(start + 300, end)``, outputs in ``<outpath>/<i>``, the config
    carrying ``scenario``, ``start`` and ``seq_number``."""
    base_out = args.outpath
    for i, row in enumerate(rows):
        args.start = int(row["start"])
        args.stop = min(args.start + MAX_FRAMES, int(row["end"]))
        if base_out is not None:
            args.outpath = os.path.join(base_out, f"{i}")
        config.update({"scenario": row["scenario"], "start": args.start,
                       "seq_number": i})
        print(f'{args.start} -> {args.stop} : {row["scenario"]}')
        infer(args, config)


def main(argv=None):
    from robust_pose_tpu_torch.scripts.infer_trajectory import main as infer
    from robust_pose_tpu_torch.utils.config import read_yaml

    args = build_parser("script to benchmark pose estimation on surgical "
                        "scenarios").parse_args(argv)
    config = read_yaml(args.config)
    run_rows(args, config, read_rows(args, "scenarios.csv"), infer)


if __name__ == "__main__":
    main()
