"""Results tables (port of ``evaluation/inspect_results.py``): per-run
ATE/RPE gathered into per-dataset mean ± std tables with macro and micro
averages, and a violin plot::

    python -m robust_pose_tpu_torch.evaluation.inspect_results <root> \\
        [--methods ...] [--source {local,wandb}] \\
        [--group-mode {test,scenario}] [--plot]

* ``--source local`` (default): a results root laid out as
  ``<root>/<method>/<dataset>/<run>/trajectory.freiburg``, with the
  ``groundtruth.txt`` next to the run or up to three folders above it; the
  metrics are computed anew.
* ``--source wandb``: the run summaries of a W&B project (credentials
  needed).

pandas is imported by the functions that build or print tables,
matplotlib and seaborn by ``--plot``, wandb by ``--source wandb``. The
main writes the gathered table to ``project.csv`` in the working
directory.
"""
import argparse
import glob
import os
import sys

import numpy as np


def collect_local(root: str, methods):
    import pandas as pd

    from robust_pose_tpu_torch.utils.evaluate import evaluate

    rows = []
    for method in methods:
        for traj in sorted(glob.glob(
                os.path.join(root, method, "**", "trajectory.freiburg"),
                recursive=True)):
            run_dir = os.path.dirname(traj)
            # the ground truth next to the run or up the tree
            gt = None
            d = run_dir
            for _ in range(4):
                cand = os.path.join(d, "groundtruth.txt")
                if os.path.isfile(cand):
                    gt = cand
                    break
                d = os.path.dirname(d)
            if gt is None:
                continue
            ate, rpe_t, rpe_r, trans_error, *_ = evaluate(gt, traj, offset=-4)
            rows.append({
                "method": method,
                "dataset": os.path.basename(os.path.dirname(run_dir)),
                "run_name": run_dir,
                "ATE/RMSE": ate,
                "RPE/trans": rpe_t,
                "RPE/rot": rpe_r,
                "frame": len(trans_error),
            })
    return pd.DataFrame(rows)


def collect_wandb(project: str, methods):
    import pandas as pd
    import wandb

    api = wandb.Api()
    rows = []
    for run in api.runs(project):
        d = dict(run.summary._json_dict)
        d.update({k: v for k, v in run.config.items() if not k.startswith("_")})
        d.update({"run_name": run.name, "state": run.state,
                  "method": run._attrs["group"], "id": run.id})
        rows.append(d)
    df = pd.DataFrame(rows)
    df = df[df.method.isin(methods)]
    if "keyframe" in df:
        df["dataset"] = [str(k)[:9] for k in df["keyframe"]]
    elif "dataset" in df:
        df["dataset"] = [os.path.basename(str(d)) for d in df["dataset"]]
    return df


def _method_block(df, metric: str):
    """One method's block: duration, the per-dataset mean ± std table and
    the macro average (the mean of the per-dataset means ± their std)."""
    import pandas as pd

    print("average duration in frames:", df["frame"].mean(), "+/-",
          df["frame"].std())
    g = pd.DataFrame({
        "mean": df.groupby("dataset", observed=True)[metric].mean(),
        "std": df.groupby("dataset", observed=True)[metric].std(),
    })
    print(g)
    print("macro average:", g["mean"].mean(), "+/-", g["mean"].std())
    return g


def report_test(runs_df, methods):
    """The test-set protocol: for ATE, RPE-trans and RPE-rot (degrees), a
    block for each method."""
    runs_df = runs_df.copy()
    runs_df["RPE/rot"] = runs_df["RPE/rot"] * 180 / np.pi  # rad -> deg
    for metric, title in (("ATE/RMSE", "ATE-RMSE in mm"),
                          ("RPE/trans", "RPE-trans in mm"),
                          ("RPE/rot", "RPE-rot in deg")):
        print("\n------------")
        print(title)
        for method in methods:
            print("\n------------")
            print(method)
            df = runs_df[runs_df.method.eq(method)]
            _method_block(df, metric)


def report_scenario(runs_df, methods, plot: bool = False):
    """The scenario protocol: ATE by method (macro and micro averages),
    then each run's ATE by dataset and keyframe."""
    print("\n------------")
    print("ATE-RMSE in mm")
    for method in methods:
        print("\n------------")
        print(method)
        df = runs_df[runs_df.method.eq(method)]
        _method_block(df, "ATE/RMSE")
        print("micro average:", df["ATE/RMSE"].mean(), "+/-",
              df["ATE/RMSE"].std())

    print("\n------------")
    print("ATE-RMSE in mm")
    key = "keyframe" if "keyframe" in runs_df else "run_name"
    for run in runs_df.dataset.unique():
        df = runs_df[runs_df.dataset.eq(run)]
        for kf in df[key].unique():
            print("\n------------")
            print(run, kf)
            df1 = df[df[key].eq(kf)]
            print(df1[["method", "ATE/RMSE"]])
    if plot:
        import matplotlib.pyplot as plt
        import seaborn as snb

        snb.violinplot(y="ATE/RMSE", x="dataset", hue="method", data=runs_df)
        plt.show()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Inspect benchmarking results (local dirs or WandB)")
    parser.add_argument("project", type=str,
                        help="results root (local) or <entity/project> (wandb)")
    parser.add_argument("--methods", nargs="+", type=str,
                        default=["test_orbslam2", "test_efusion", "test_ours"])
    parser.add_argument("--source", choices=["local", "wandb"],
                        default="local")
    parser.add_argument("--group-mode", choices=["test", "scenario"],
                        default="test",
                        help="'test': the test-set comparison tables; "
                             "'scenario': the scenario ATE protocol")
    parser.add_argument("--plot", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.source == "wandb":
        df = collect_wandb(args.project, args.methods)
    else:
        df = collect_local(args.project, args.methods)
    if df.empty:
        print("no runs found")
        sys.exit(1)
    # methods in the order given (a categorical sort)
    df["method"] = df["method"].astype("category").cat.set_categories(
        args.methods)
    df = df.sort_values(["method"])
    df.to_csv("project.csv")
    if args.group_mode == "test":
        report_test(df, args.methods)
    else:
        report_scenario(df, args.methods, args.plot)


if __name__ == "__main__":
    main()
