"""The port's data layer on the CPU against the JAX package: the device
preprocessing (``data/device_preproc.py``, each function and
``DevicePreproc``) against the JAX functions and cv2, and the host modules
(transforms, rectification, the PNG and video datasets, ``get_data``,
``SequentialSubSampler``) against the JAX package's on the same files.

Masks and nearest paths must agree bit for bit, bilinear paths within
1e-4 (0-255 scale); host frames, masks, calibrations and poses exactly.
"""
import contextlib
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu.data import dataset_utils as jdu
from robust_pose_tpu.data import device_preproc as jdp
from robust_pose_tpu.data import rectification as jrect
from robust_pose_tpu.data import stereo_dataset as jsd
from robust_pose_tpu.data import transforms as jtr
from robust_pose_tpu.data import video_dataset as jvd
from robust_pose_tpu_torch.data import dataset_utils as pdu
from robust_pose_tpu_torch.data import device_preproc as pdp
from robust_pose_tpu_torch.data import rectification as prect
from robust_pose_tpu_torch.data import stereo_dataset as psd
from robust_pose_tpu_torch.data import transforms as ptr
from robust_pose_tpu_torch.data import video_dataset as pvd

H, W = 64, 96
N_VIDEO = 6
N_PNG = 5
BILINEAR_TOL = 1e-4


# --- fixtures (the recipes of tests/test_video_dataset.py and
# tests/test_infer_cli.py) ----------------------------------------------------

def camcal(w=W, h=H, k=(0, 0, 0, 0, 0), om=(0.0, 0.0, 0.0), c_right=None):
    """A ``camcal.json`` calibration dict."""
    cr = c_right or [w / 2, h / 2]
    return {"data": {"width": w, "height": h, "intrinsics": [
        {"f": [100.0, 100.0], "c": [w / 2, h / 2], "k": list(k)},
        {"f": [100.0, 100.0], "c": cr, "k": list(k)}],
        "extrinsics": {"T": [-3.0, 0.0, 0.0], "om": list(om)}}}


def write_video_sequence(root, n=N_VIDEO, h=H, w=W, seed=0, specular=False):
    """A vertically stacked stereo mp4 (``video.mp4``), its timestamps
    (``video.json``), ``groundtruth.txt`` and ``camcal.json`` in ``root``."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(
        rng.integers(0, 255, (2 * h, w + 16, 3)).astype(np.float32), (0, 0), 2
    ).astype(np.uint8)
    if specular:
        base[10:22, 30:50] = 255
        base[h + 30:h + 40, 20:44] = 255
    vw = cv2.VideoWriter(str(root / "video.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, 2 * h))
    assert vw.isOpened(), "mp4 writer unavailable"
    for i in range(n):
        vw.write(base[:, 2 * i:2 * i + w])
    vw.release()
    with open(root / "video.json", "w") as f:
        json.dump([{"timestamp": 100 + i} for i in range(n)], f)
    with open(root / "groundtruth.txt", "w") as f:
        f.write("\n".join(f"{i} {0.001 * i} 0.0 0.0 0.0 0.0 0.0 1.0"
                          for i in range(1, n + 1)) + "\n")
    with open(root / "camcal.json", "w") as f:
        json.dump(camcal(w, h), f)
    return str(root)


def write_png_sequence(root, n=N_PNG, h=H, w=W, first=1):
    """``video_frames/{i:06d}l.png``/``r.png``, ``masks/{i:06d}l.png``,
    ``camcal.json`` and ``groundtruth.txt`` in ``root``
    (tests/test_infer_cli.py's sequence; frames numbered from ``first``,
    ground-truth stamps from 1)."""
    (root / "video_frames").mkdir()
    (root / "masks").mkdir()
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(
        rng.integers(0, 255, (h, w + 32, 3)).astype(np.float32), (0, 0), 2
    ).astype(np.uint8)
    with open(root / "camcal.json", "w") as f:
        json.dump(camcal(w, h), f)
    for i in range(1, n + 1):
        left = base[:, 2 * i:2 * i + w]
        right = base[:, 2 * i + 3:2 * i + 3 + w]
        name = f"{i + first - 1:06d}"
        cv2.imwrite(str(root / "video_frames" / f"{name}l.png"),
                    cv2.cvtColor(left, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(root / "video_frames" / f"{name}r.png"),
                    cv2.cvtColor(right, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(root / "masks" / f"{name}l.png"),
                    np.full((h, w), 255, np.uint8))
    lines = [f"{i} {0.001 * i} 0.0 0.0 0.0 0.0 0.0 1.0"
             for i in range(1, n + first)]
    with open(root / "groundtruth.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    return write_video_sequence(tmp_path_factory.mktemp("port_vid"),
                                specular=True)


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    return write_png_sequence(tmp_path_factory.mktemp("port_png"))


RNG = np.random.default_rng(7)


def _img(h=48, w=64, c=3):
    return RNG.uniform(0, 255, (h, w, c)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- device preprocessing, function by function -------------------------------

def test_remap_bilinear_matches_jax_and_cv2():
    img = _img()
    h, w = img.shape[:2]
    mx = RNG.uniform(-2, w + 1, (h, w)).astype(np.float32)
    my = RNG.uniform(-2, h + 1, (h, w)).astype(np.float32)
    out = pdp.remap_bilinear(_t(img), _t(mx), _t(my)).numpy()
    ref = np.asarray(jdp.remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                                        jnp.asarray(my)))
    np.testing.assert_allclose(out, ref, atol=BILINEAR_TOL)
    np.testing.assert_allclose(
        out, cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR), atol=1e-3)


def test_remap_nearest_matches_jax_and_cv2_bit_for_bit():
    img = _img()
    h, w = img.shape[:2]
    mx = (RNG.integers(-2, w + 1, (h, w))
          + RNG.uniform(0.05, 0.45, (h, w))).astype(np.float32)
    my = (RNG.integers(-2, h + 1, (h, w))
          + RNG.uniform(0.05, 0.45, (h, w))).astype(np.float32)
    out = pdp.remap_nearest(_t(img), _t(mx), _t(my)).numpy()
    ref = np.asarray(jdp.remap_nearest(jnp.asarray(img), jnp.asarray(mx),
                                       jnp.asarray(my)))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out, cv2.remap(img, mx, my, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("k", [11, 5])
def test_erode_matches_jax_and_cv2(k):
    mask = RNG.uniform(size=(40, 56)) > 0.15
    out = pdp.erode_mask(_t(mask), k).numpy()
    np.testing.assert_array_equal(out, np.asarray(jdp.erode_mask(jnp.asarray(mask), k)))
    np.testing.assert_array_equal(
        out, cv2.erode(mask.astype(np.uint8), kernel=np.ones((k, k))) > 0)


@pytest.mark.parametrize("prior", [False, True])
def test_mask_specularities_matches_jax_and_host(prior):
    img = _img()
    img[10:14, 20:30] = 255.0
    img[30:40, 5:9] = 250.0
    pm = RNG.uniform(size=img.shape[:2]) > 0.05 if prior else None
    out = pdp.mask_specularities(_t(img), None if pm is None else _t(pm)).numpy()
    ref = np.asarray(jdp.mask_specularities(
        jnp.asarray(img), None if pm is None else jnp.asarray(pm)))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jsd.mask_specularities(img, pm))
    np.testing.assert_array_equal(out, psd.mask_specularities(img, pm))


@pytest.mark.parametrize("size", [(24, 40), (72, 96), (48, 64), (32, 64)])
def test_resize_bilinear_matches_jax_and_cv2(size):
    img = _img()
    out = pdp.resize_bilinear(_t(img), size).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jdp.resize_bilinear(jnp.asarray(img), size)),
        atol=BILINEAR_TOL)
    np.testing.assert_allclose(
        out, cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_LINEAR),
        atol=2e-3)


@pytest.mark.parametrize("size", [(24, 40), (72, 96), (32, 64)])
def test_resize_nearest_matches_jax_and_cv2(size):
    img = _img(c=1)
    out = pdp.resize_nearest(_t(img), size).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(jdp.resize_nearest(jnp.asarray(img), size)))
    np.testing.assert_array_equal(
        out, cv2.resize(img, (size[1], size[0]),
                        interpolation=cv2.INTER_NEAREST)[..., None])


@pytest.mark.parametrize("shift", [(3.25, -1.75), (-0.5, 0.25)])
def test_translate_matches_jax_and_warpaffine(shift):
    img = _img()
    tx, ty = shift
    out = pdp.translate_bilinear(_t(img), tx, ty).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jdp.translate_bilinear(jnp.asarray(img), tx, ty)),
        atol=BILINEAR_TOL)
    tmat = np.array(((1, 0, tx), (0, 1, ty)), np.float32)
    np.testing.assert_allclose(
        out, cv2.warpAffine(img, tmat, (img.shape[1], img.shape[0])), atol=1e-3)


class _Pseudo:
    """The fields of a pseudo-mode rectifier that DevicePreproc reads."""
    mode = "pseudo"
    cal = {"lkmat": np.array([[500.0, 0, 40.5], [0, 500.0, 30.25], [0, 0, 1]]),
           "rkmat": np.array([[500.0, 0, 37.0], [0, 500.0, 31.0], [0, 0, 1]])}


class _Maps:
    """A conventional-mode rectifier's fields: smooth sub-pixel maps."""
    mode = "conventional"

    def __init__(self, h, w, seed=5):
        rng = np.random.default_rng(seed)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        self.maps = {}
        for side in "lr":
            a, b = rng.uniform(0.3, 0.9, 2)
            self.maps[side + "map1"] = (xs + a * np.sin(ys / 9.0)).astype(np.float32)
            self.maps[side + "map2"] = (ys + b * np.cos(xs / 7.0)).astype(np.float32)


@pytest.mark.parametrize("case", ["none", "maps", "pseudo", "resize_prior"])
def test_device_preproc_matches_jax(case):
    """DevicePreproc on CPU tensors against the JAX class: mask bit for
    bit, images within 1e-4 (the nearest remap of bilinear-resized pixels
    exactly where the resize agrees)."""
    limg = RNG.uniform(0, 255, (64, 96, 3)).astype(np.uint8)
    rimg = RNG.uniform(0, 255, (64, 96, 3)).astype(np.uint8)
    limg[20:30, 40:60] = 255
    size_wh = (80, 48) if case in ("none", "resize_prior") else (96, 64)
    rect = {"none": None, "resize_prior": None, "maps": _Maps(64, 96),
            "pseudo": _Pseudo()}[case]
    prior = (RNG.uniform(size=(64, 96)) > 0.02) if case == "resize_prior" else None
    port = pdp.DevicePreproc(size_wh, rectifier=rect, device="cpu")
    got = port(limg, rimg, prior)
    ref = jdp.DevicePreproc(size_wh, rectifier=rect)(limg, rimg, prior)
    assert got[0].shape == (3, size_wh[1], size_wh[0]) and got[0].dtype == torch.float32
    assert got[2].shape == (1, size_wh[1], size_wh[0]) and got[2].dtype == torch.bool
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BILINEAR_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if case == "maps":      # no resize: the nearest remap of exact pixels
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_device_preproc_needs_a_device_choice_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdp.DevicePreproc((96, 64))


# --- host modules ------------------------------------------------------------------

@pytest.mark.parametrize("size_wh", [(W, H), (80, 48), (120, 72)])
def test_resize_stereo_matches_jax(size_wh):
    img = _img(64, 96)
    mask = RNG.uniform(size=(64, 96)) > 0.3
    got = ptr.ResizeStereo(size_wh)(img, img[::-1].copy(), mask)
    ref = jtr.ResizeStereo(size_wh)(img, img[::-1].copy(), mask)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    both = ptr.Compose([ptr.ResizeStereo(size_wh)])(img, img, None)
    assert both[2] is None and both[0].shape[:2] == (size_wh[1], size_wh[0])


def _write_calib(root, fmt):
    """A calibration file of each format the rectifier reads, with
    distortion and a small rotation."""
    if fmt in ("json", "json_pseudo"):
        cal = camcal(k=(0.01, -0.02, 0.001, 0.0005, 0.0), om=(0.01, -0.02, 0.005),
                     c_right=[W / 2 - 1.5, H / 2 + 0.75])
        path = root / "camcal.json"
        path.write_text(json.dumps(cal))
    elif fmt == "ini":
        lines = ["[StereoLeft]", "res_x=96", "res_y=64", "fc_x=100.0",
                 "fc_y=101.0", "cc_x=47.5", "cc_y=31.5"]
        lines += [f"kc_{i}={v}" for i, v in enumerate(
            [0.01, -0.02, 0.001, 0.0005, 0, 0, 0, 0])]
        lines += ["[StereoRight]", "fc_x=99.0", "fc_y=100.0", "cc_x=48.5",
                  "cc_y=32.0"]
        lines += [f"kc_{i}={v}" for i, v in enumerate(
            [0.02, -0.01, 0.0, 0.001, 0, 0, 0, 0])]
        lines += [f"T_{i}={v}" for i, v in enumerate([-3.0, 0.05, 0.01])]
        R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
        lines += [f"R_{i}={float(v)!r}" for i, v in enumerate(R.reshape(-1))]
        path = root / "StereoCalibration.ini"
        path.write_text("\n".join(lines) + "\n")
    else:
        path = root / "endoscope_calibration.yaml"
        fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_WRITE)
        fs.write("M1", np.array([[100.0, 0, 47.5], [0, 101.0, 31.5], [0, 0, 1]]))
        fs.write("M2", np.array([[99.0, 0, 48.5], [0, 100.0, 32.0], [0, 0, 1]]))
        fs.write("D1", np.array([[0.01, -0.02, 0.001, 0.0005, 0.0]]))
        fs.write("D2", np.array([[0.02, -0.01, 0.0, 0.001, 0.0]]))
        fs.write("T", np.array([[-3.0], [0.05], [0.01]]))
        fs.write("R", cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0])
        fs.release()
        with open(path, "a") as f:      # keys cv2's writer refuses
            f.write("Camera.width: 96\nCamera.height: 64\n")
    return str(path)


@pytest.mark.parametrize("fmt,size", [("json", None), ("json", (80, 48)),
                                      ("json_pseudo", (80, 48)), ("ini", None),
                                      ("yaml", (64, 40))])
def test_stereo_rectifier_matches_jax(tmp_path, fmt, size):
    """Maps, rectified calibration and the host rectification of a pair
    equal the JAX package's bit for bit, in every calibration format."""
    path = _write_calib(tmp_path, fmt)
    mode = "pseudo" if fmt == "json_pseudo" else "conventional"
    with pytest.warns(UserWarning) if mode == "pseudo" else contextlib.nullcontext():
        got = prect.StereoRectifier(path, img_size_new=size, mode=mode)
    with pytest.warns(UserWarning) if mode == "pseudo" else contextlib.nullcontext():
        ref = jrect.StereoRectifier(path, img_size_new=size, mode=mode)
    assert got.maps.keys() == ref.maps.keys()
    for k in ref.maps:
        np.testing.assert_array_equal(got.maps[k], ref.maps[k])
    gc, rc = got.get_rectified_calib(), ref.get_rectified_calib()
    assert gc.keys() == rc.keys()
    for k in rc:
        if k == "intrinsics":
            for side in ("left", "right"):
                np.testing.assert_array_equal(gc[k][side], rc[k][side])
        else:
            np.testing.assert_array_equal(gc[k], rc[k])
    w, h = (int(v) for v in got.img_size)
    limg, rimg = _img(h, w), _img(h, w)
    for g, r in zip(got(limg, rimg), ref(limg, rimg)):
        np.testing.assert_array_equal(g, r)


def test_stereo_dataset_matches_jax(png_dir, tmp_path):
    """Frames, masks (side-car mask AND specularities) and frame numbers;
    a missing side-car mask gives the all-True prior in both."""
    got = psd.StereoDataset(png_dir, (80, 48))
    ref = jsd.StereoDataset(png_dir, (80, 48))
    assert len(got) == len(ref) == N_PNG
    for i in range(N_PNG):
        for g, r in zip(got[i], ref[i]):
            np.testing.assert_array_equal(g, r)
    os.remove(os.path.join(png_dir, "masks", "000002l.png"))
    for g, r in zip(psd.StereoDataset(png_dir, (W, H))[1],
                    jsd.StereoDataset(png_dir, (W, H))[1]):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("raw,sample,size", [(False, 1, (W, H)),
                                             (False, 2, (80, 48)),
                                             (True, 1, (W, H)),
                                             (True, 3, (W, H))])
def test_video_dataset_matches_jax(video_dir, raw, sample, size):
    """Every item (frames, mask, pose, number) of the port's
    StereoVideoDataset equals the JAX package's, rectified and not, raw
    and not, subsampled."""
    video = os.path.join(video_dir, "video.mp4")
    gt = os.path.join(video_dir, "groundtruth.txt")
    rect = prect.StereoRectifier(os.path.join(video_dir, "camcal.json"), size)
    jrec = jrect.StereoRectifier(os.path.join(video_dir, "camcal.json"), size)
    got = pvd.StereoVideoDataset(video, gt, img_size=size, rectify=rect,
                                 sample=sample)
    ref = jvd.StereoVideoDataset(video, gt, img_size=size, rectify=jrec,
                                 sample=sample)
    got.raw = ref.raw = raw
    assert len(got) == len(ref)
    items_g, items_r = list(got), list(ref)
    assert len(items_g) == len(items_r) == -(-N_VIDEO // sample)
    for ig, ir in zip(items_g, items_r):
        assert len(ig) == len(ir) == (4 if raw else 5)
        for g, r in zip(ig, ir):
            if isinstance(r, str):
                assert g == r
            else:
                assert g.dtype == r.dtype and g.shape == r.shape
                np.testing.assert_array_equal(g, r)


def test_video_dataset_without_poses_yields_identity(video_dir):
    video = os.path.join(video_dir, "video.mp4")
    got, ref = list(pvd.StereoVideoDataset(video)), list(jvd.StereoVideoDataset(video))
    for ig, ir in zip(got, ref):
        np.testing.assert_array_equal(ig[3], ir[3])
        assert ig[3].dtype == np.float32


@pytest.mark.parametrize("which", ["png", "video"])
def test_get_data_matches_jax(png_dir, video_dir, which):
    """get_data picks the same dataset class and the same calibration."""
    root = png_dir if which == "png" else video_dir
    ds, calib = pdu.get_data(root, (W, H))
    jds, jcalib = jdu.get_data(root, (W, H))
    assert type(ds).__name__ == type(jds).__name__
    assert calib.keys() == jcalib.keys()
    np.testing.assert_array_equal(calib["intrinsics"]["left"],
                                  jcalib["intrinsics"]["left"])
    assert calib["bf"] == jcalib["bf"] and calib["img_size"] == jcalib["img_size"]
    got = list(pdu.prefetch_iterator(pdu.iterate_dataset(ds), depth=2))
    ref = list(jdu.iterate_dataset(jds))
    assert len(got) == len(ref) > 0
    for ig, ir in zip(got, ref):
        for g, r in zip(ig, ir):
            if isinstance(r, str):
                assert g == r
            else:
                np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("start,stop,step", [(0, -1, 1), (1, 4, 2), (2, 100, 1)])
def test_sequential_subsampler_matches_jax(png_dir, start, stop, step):
    ds = psd.StereoDataset(png_dir, (W, H))
    got = pdu.SequentialSubSampler(ds, start, stop, step)
    ref = jdu.SequentialSubSampler(ds, start, stop, step)
    assert list(got) == list(ref) and len(got) == len(ref)
    numbers = [item[3] for item in pdu.iterate_dataset(ds, got)]
    assert numbers == [item[3] for item in jdu.iterate_dataset(ds, ref)]


def test_find_calib_file_refuses_an_empty_folder(tmp_path):
    with pytest.raises(RuntimeError, match="no valid calibration"):
        pdu.find_calib_file(str(tmp_path))


def test_prefetch_iterator_surfaces_errors():
    def gen():
        yield 1
        raise ValueError("decode failed")

    it = pdu.prefetch_iterator(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)
