"""cv2 keypoint converters (port of ``robust_pose_tpu/utils/opencv.py``).
cv2 is imported inside the function that needs it."""
import numpy as np


def kpts2npy(cv2kpts) -> np.ndarray:
    """cv2 keypoints -> (N, 2) array of their (x, y) positions."""
    return np.array([[kp.pt[0], kp.pt[1]] for kp in cv2kpts])


def npy2kpts(np_pts):
    """(N, 2) positions -> cv2 keypoints of size 1."""
    import cv2

    return [cv2.KeyPoint(float(pt[0]), float(pt[1]), 1.0) for pt in np_pts]
