"""Stereo rectification (port of ``robust_pose_tpu/data/rectification.py``).

Host-side numpy/OpenCV: calibration parsing (json / ini / yaml),
``cv2.stereoRectify`` map building and the per-image remap, in the
'conventional' and 'pseudo' modes (pseudo: a 2D shift of the right image
by the principal-point delta, used for SCARED). The same numpy/cv2
arithmetic as the JAX package, so maps and rectified calibration equal
its own bit for bit. cv2 is imported inside the functions that call it.
"""
from __future__ import annotations

import configparser
import json
import os
import warnings
from typing import Optional, Tuple

import numpy as np


def get_rect_maps(lcam_mat, rcam_mat, rmat, tvec, ldist_coeffs, rdist_coeffs,
                  img_size: Tuple[int, int], mode: str = "conventional"):
    """(reference dataset/preprocess/stereo_rectify.py:5-44)"""
    import cv2
    if mode == "conventional":
        r1, r2, p1, p2, _, _, _ = cv2.stereoRectify(
            cameraMatrix1=lcam_mat.astype("float64"),
            distCoeffs1=np.asarray(ldist_coeffs, "float64").reshape(-1),
            cameraMatrix2=rcam_mat.astype("float64"),
            distCoeffs2=np.asarray(rdist_coeffs, "float64").reshape(-1),
            imageSize=tuple(int(s) for s in img_size),
            R=rmat.astype("float64"),
            # OpenCV >= 5 requires a (3,1) column translation
            T=np.asarray(tvec, "float64").reshape(3, 1),
            alpha=0,
        )
        lmap1, lmap2 = cv2.initUndistortRectifyMap(
            cameraMatrix=lcam_mat, distCoeffs=ldist_coeffs, R=r1,
            newCameraMatrix=p1, size=tuple(int(s) for s in img_size),
            m1type=cv2.CV_32FC1,
        )
        # NOTE: the reference passes ldist_coeffs for the right map too
        # (stereo_rectify.py:31) — replicated for output parity
        rmap1, rmap2 = cv2.initUndistortRectifyMap(
            cameraMatrix=rcam_mat, distCoeffs=ldist_coeffs, R=r2,
            newCameraMatrix=p2, size=tuple(int(s) for s in img_size),
            m1type=cv2.CV_32FC1,
        )
        maps = {"lmap1": lmap1, "lmap2": lmap2, "rmap1": rmap1, "rmap2": rmap2}
    elif mode == "pseudo":
        maps = {}
        p1 = lcam_mat.astype("float64")
        p2 = rcam_mat.astype("float64")
    else:
        raise NotImplementedError(mode)
    return maps, p1, p2


def rectify_pair(limg, rimg, maps, method: str = "nearest"):
    """(reference stereo_rectify.py:47-53)"""
    import cv2
    interp = cv2.INTER_NEAREST if method == "nearest" else cv2.INTER_CUBIC
    limg_rect = cv2.remap(np.copy(limg), maps["lmap1"], maps["lmap2"],
                          interpolation=interp)
    rimg_rect = cv2.remap(np.copy(rimg), maps["rmap1"], maps["rmap2"],
                          interpolation=interp)
    return limg_rect, rimg_rect


def pseudo_rectify_2d(rimg, x0, x1, y0, y1):
    """Affine shift by the principal-point delta (stereo_rectify.py:59-64)."""
    import cv2
    tmat = np.array(((1, 0, x0 - x1), (0, 1, y0 - y1))).astype(np.float32)
    return cv2.warpAffine(rimg, tmat, (rimg.shape[1], rimg.shape[0]))


class StereoRectifier:
    """(reference dataset/rectification.py:12-101)

    :param calib_file: .json / .ini / .yaml calibration
    :param img_size_new: (W, H) target size — intrinsics are rescaled and
        vertically cropped (rectification.py:28-38)
    :param mode: 'conventional' | 'pseudo'
    """

    def __init__(self, calib_file: str, img_size_new: Optional[Tuple] = None,
                 mode: str = "conventional"):
        ext = os.path.splitext(calib_file)[1]
        if ext == ".json":
            cal = self._load_calib_json(calib_file)
        elif ext == ".ini":
            cal = self._load_calib_ini(calib_file)
        elif ext == ".yaml":
            cal = self._load_calib_yaml(calib_file)
        else:
            raise NotImplementedError(ext)

        assert mode in ("conventional", "pseudo")
        self.mode = mode
        if self.mode == "pseudo":
            warnings.warn("pseudo rectification used", UserWarning)

        self.scale = 1.0
        if img_size_new is not None:
            self.scale = img_size_new[0] / cal["img_size"][0]
            h_crop = int((cal["img_size"][1] * self.scale - img_size_new[1]) / 2)
            assert h_crop >= 0, "only vertical crop implemented"
            cal["lkmat"][:2] *= self.scale
            cal["rkmat"][:2] *= self.scale
            cal["lkmat"][1, 2] -= h_crop
            cal["rkmat"][1, 2] -= h_crop
            cal["img_size"] = img_size_new
        self.img_size = cal["img_size"]
        self.cal = cal

        self.maps, self.l_intr, self.r_intr = get_rect_maps(
            lcam_mat=cal["lkmat"], rcam_mat=cal["rkmat"], rmat=cal["R"],
            tvec=cal["T"], ldist_coeffs=cal["ld"], rdist_coeffs=cal["rd"],
            img_size=cal["img_size"], mode=self.mode,
        )

    def __call__(self, img_left: np.ndarray, img_right: np.ndarray):
        """Rectify an HWC image pair (numpy; the reference round-trips
        through torch CHW — rectification.py:53-65)."""
        if self.mode == "pseudo":
            x0, x1 = self.cal["lkmat"][0][-1], self.cal["rkmat"][0][-1]
            y0, y1 = self.cal["lkmat"][1][-1], self.cal["rkmat"][1][-1]
            return img_left, pseudo_rectify_2d(img_right, x0, x1, y0, y1)
        return rectify_pair(img_left, img_right, self.maps)

    def get_rectified_calib(self) -> dict:
        """(reference rectification.py:67-78) — bf = |T| * fx in pixels."""
        calib = {"intrinsics": {}}
        calib["intrinsics"]["left"] = self.l_intr[:3, :3]
        calib["intrinsics"]["right"] = self.r_intr[:3, :3]
        calib["extrinsics"] = np.eye(4)
        if self.mode == "conventional":
            calib["extrinsics"][:3, 3] = np.array(
                [self.r_intr[0, 3] / self.r_intr[0, 0], 0.0, 0.0]
            )
        else:
            calib["extrinsics"][:3, 3] = np.asarray(self.cal["T"]).squeeze()[:3]
        calib["bf"] = float(
            np.sqrt(np.sum(calib["extrinsics"][:3, 3] ** 2)) * self.l_intr[0, 0]
        )
        calib["bf_orig"] = calib["bf"] / self.scale
        calib["img_size"] = self.img_size
        return calib

    # -- calibration formats (reference rectification.py:80-184) -----------

    @staticmethod
    def _load_calib_json(fname):
        import cv2
        with open(fname, "rb") as f:
            d = json.load(f)
        lkmat = np.eye(3)
        lkmat[0, 0], lkmat[1, 1] = d["data"]["intrinsics"][0]["f"][:2]
        lkmat[:2, -1] = d["data"]["intrinsics"][0]["c"]
        rkmat = np.eye(3)
        rkmat[0, 0], rkmat[1, 1] = d["data"]["intrinsics"][1]["f"][:2]
        rkmat[:2, -1] = d["data"]["intrinsics"][1]["c"]
        return {
            "lkmat": lkmat,
            "rkmat": rkmat,
            "ld": np.array(d["data"]["intrinsics"][0]["k"]),
            "rd": np.array(d["data"]["intrinsics"][1]["k"]),
            "T": np.array(d["data"]["extrinsics"]["T"]),
            "R": cv2.Rodrigues(np.array(d["data"]["extrinsics"]["om"]))[0],
            "img_size": (d["data"]["width"], d["data"]["height"]),
        }

    @staticmethod
    def _load_calib_ini(fname):
        config = configparser.ConfigParser()
        config.read(fname)
        L, R = config["StereoLeft"], config["StereoRight"]
        lkmat = np.eye(3)
        lkmat[0, 0], lkmat[1, 1] = float(L["fc_x"]), float(L["fc_y"])
        lkmat[0, 2], lkmat[1, 2] = float(L["cc_x"]), float(L["cc_y"])
        rkmat = np.eye(3)
        rkmat[0, 0], rkmat[1, 1] = float(R["fc_x"]), float(R["fc_y"])
        rkmat[0, 2], rkmat[1, 2] = float(R["cc_x"]), float(R["cc_y"])
        return {
            "lkmat": lkmat,
            "rkmat": rkmat,
            "ld": np.array([float(L[f"kc_{i}"]) for i in range(8)]),
            "rd": np.array([float(R[f"kc_{i}"]) for i in range(8)]),
            "T": np.array([float(R[f"T_{i}"]) for i in range(3)]),
            "R": np.array([float(R[f"R_{i}"]) for i in range(9)]).reshape(3, 3),
            "img_size": (float(L["res_x"]), float(L["res_y"])),
        }

    @staticmethod
    def _load_calib_yaml(fname):
        import cv2
        fs = cv2.FileStorage(fname, cv2.FILE_STORAGE_READ)
        return {
            "lkmat": fs.getNode("M1").mat(),
            "rkmat": fs.getNode("M2").mat(),
            "ld": fs.getNode("D1").mat(),
            "rd": fs.getNode("D2").mat(),
            "T": fs.getNode("T").mat(),
            "R": fs.getNode("R").mat(),
            "img_size": (
                int(fs.getNode("Camera.width").real()),
                int(fs.getNode("Camera.height").real()),
            ),
        }
