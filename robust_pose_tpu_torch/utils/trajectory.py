"""TUM/Freiburg trajectory I/O (port of ``robust_pose_tpu/utils/trajectory.py``,
the port's own copy: host-side numpy/scipy, no device work).

Poses are SE(3) 7-vectors [tx ty tz qx qy qz qw]; distances are
millimetres in memory and metres in files (x1000 on read, /1000 on
write), and ``read_freiburg`` keeps the reference's timestamp
decimal-collapse heuristic. ``save_trajectory`` takes host (numpy) poses.
"""
from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


def mat2vec(transforms: np.ndarray) -> np.ndarray:
    """(N, 4, 4) homogeneous matrices -> (N, 7) SE(3) vectors."""
    transforms = np.asarray(transforms)
    quat = Rotation.from_matrix(transforms[..., :3, :3]).as_quat()
    trans = transforms[..., :3, 3]
    return np.concatenate([trans.reshape(-1, 3), quat.reshape(-1, 4)], axis=-1)


def vec2mat(vecs: np.ndarray) -> np.ndarray:
    """(N, 7) SE(3) vectors -> (N, 4, 4) homogeneous matrices."""
    vecs = np.asarray(vecs).reshape(-1, 7)
    m = np.tile(np.eye(4), (len(vecs), 1, 1))
    m[:, :3, :3] = Rotation.from_quat(vecs[:, 3:]).as_matrix()
    m[:, :3, 3] = vecs[:, :3]
    return m


def save_trajectory(trajectory: List[dict], path: str,
                    filename: str = "trajectory.freiburg"):
    """Write ``[{'camera-pose': vec7, 'timestamp': t}, ...]`` in TUM format
    (translation mm -> m; reference core/utils/trajectory.py:17-23)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, filename), "w") as f:
        for tr in trajectory:
            vec = np.asarray(tr["camera-pose"]).reshape(7)
            t = vec[:3] / 1000.0
            f.write(
                f"{tr['timestamp']} {t[0]} {t[1]} {t[2]} "
                f"{vec[3]} {vec[4]} {vec[5]} {vec[6]}\n"
            )


def read_freiburg(path: str, ret_stamps: bool = False, no_stamp: bool = False):
    """Read a TUM trajectory -> (N, 7) pose vectors (translation m -> mm).

    (reference core/utils/trajectory.py:38-62, including the timestamp
    decimal-collapse heuristic ``int(sec+frac)*100``)
    """
    with open(path, "r") as f:
        data = f.read()
    lines = data.replace(",", " ").replace("\t", " ").split("\n")
    rows = [
        [v.strip() for v in line.split(" ") if v.strip() != ""]
        for line in lines
        if len(line) > 0 and line[0] != "#"
    ]
    rows = [r for r in rows if len(r) > 0]
    if no_stamp:
        trans = np.asarray([r[0:3] for r in rows], dtype=float) * 1000.0
        quat = np.asarray([r[3:7] for r in rows], dtype=float)
        return np.concatenate([trans, quat], axis=-1)

    stamps_raw = [r[0] for r in rows]
    try:
        stamps = np.asarray(
            [int(s.split(".")[0] + s.split(".")[1]) for s in stamps_raw]
        ) * 100
    except IndexError:
        stamps = np.asarray([int(s) for s in stamps_raw])
    trans = np.asarray([r[1:4] for r in rows], dtype=float) * 1000.0
    quat = np.asarray([r[4:8] for r in rows], dtype=float)
    poses = np.concatenate([trans, quat], axis=-1)
    if ret_stamps:
        return poses, stamps
    return poses


def json2freiburg(json_path: str, outpath: str):
    """Intuitive-JSON -> freiburg, with the axis-convention flip
    (reference core/utils/trajectory.py:26-36)."""
    with open(str(json_path), "r") as f:
        pose_elem_list = json.load(f)
    pose_list = []
    for elem in pose_elem_list:
        pose = np.array(elem["camera-pose"], dtype=float)
        pose[0:3, 3] = -pose[0:3, 3]
        pose[0:3, 0:3] = pose[0:3, 0:3].T
        vec = mat2vec(pose[None])[0]
        pose_list.append({"camera-pose": vec, "timestamp": elem["timestamp"]})
    save_trajectory(pose_list, outpath)


def read_json_intuitive(path: str, with_stamp: bool = True):
    """(reference core/utils/trajectory.py:64-83)"""
    with open(os.path.join(path), "r") as f:
        raw = json.load(f)
    mats = []
    stamps = np.asarray([r["timestamp"] for r in raw]) if with_stamp else None
    for r in raw:
        if with_stamp:
            pose = np.eye(4)
            pose[:3, :3] = np.asarray(r["camera_pose"][3:]).reshape(3, 3)
            pose[:3, 3] = np.asarray(r["camera_pose"][:3])
        else:
            if isinstance(r, dict):
                r = r["camera-pose"]
            pose = np.asarray(r)
        mats.append(pose)
    poses = mat2vec(np.stack(mats))
    if with_stamp:
        return poses, stamps
    return poses
