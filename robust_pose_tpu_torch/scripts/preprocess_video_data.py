"""Dataset preparation CLI (port of ``scripts/preprocess_video_data.py``),
host only: decodes stereo mp4s, splits the vertically stacked pair, masks
specularities, resizes and crops, rectifies, and writes
``{i:06d}l/r.png`` frame pairs to ``video_frames/`` for each sequence
listed in ``sequences.txt``::

    python -m robust_pose_tpu_torch.scripts.preprocess_video_data <root> \\
        [--outpath <dir>] [--rect_mode conventional|pseudo]

Needs cv2 (decoding, rectification maps, PNG writing).
"""
import argparse
import os

import numpy as np


def _check_valid(valid_list, n):
    if valid_list is None:
        return True
    return any((n >= v[0]) and (n < v[1]) for v in valid_list)


def main(input_path, output_path, step, rect_mode, img_size=(640, 512)):
    import cv2

    from robust_pose_tpu_torch.data.dataset_utils import StereoVideoDataset, get_data

    # only extract valid frames for training
    split = os.path.join(input_path, "train_split.csv")
    valid_list = (np.genfromtxt(split, skip_header=1, delimiter=",")
                  if os.path.isfile(split) else None)
    if valid_list is not None and valid_list.ndim == 1:
        valid_list = valid_list[None]

    dataset, calib = get_data(input_path, img_size, sample_video=step,
                              rect_mode=rect_mode)
    assert isinstance(dataset, StereoVideoDataset)

    os.makedirs(os.path.join(output_path, "video_frames"), exist_ok=True)
    for limg, rimg, _, _, img_number in dataset:
        if _check_valid(valid_list, int(img_number)):
            name = f"{int(img_number):06d}"
            cv2.imwrite(
                os.path.join(output_path, "video_frames", name + "l.png"),
                cv2.cvtColor(limg.transpose(1, 2, 0),
                             cv2.COLOR_RGB2BGR).astype(np.uint8),
            )
            cv2.imwrite(
                os.path.join(output_path, "video_frames", name + "r.png"),
                cv2.cvtColor(rimg.transpose(1, 2, 0),
                             cv2.COLOR_RGB2BGR).astype(np.uint8),
            )
    print("finished")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="script to extract stereo data")
    parser.add_argument("input", type=str, help="Path to input folder.")
    parser.add_argument("--outpath", type=str,
                        help="Output folder; defaults to input.")
    parser.add_argument("--rect_mode", type=str,
                        choices=["conventional", "pseudo"],
                        default="conventional",
                        help="rectification mode, use pseudo for SCARED")
    args = parser.parse_args()
    if args.outpath is None:
        args.outpath = args.input
    seqs = np.genfromtxt(os.path.join(args.input, "sequences.txt"),
                         skip_header=1, delimiter=",", dtype=str)
    seqs = seqs[None, ...] if seqs.shape == (2,) else seqs
    for d in seqs:
        print(f"extract {d[0]}")
        try:
            main(os.path.join(args.input, d[0]),
                 os.path.join(args.outpath, d[0]), 1, args.rect_mode)
        except IndexError:
            pass
        except AssertionError:
            print(f"skip {d[0]}, already extracted")
