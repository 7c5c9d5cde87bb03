"""The port's NYUv2 data path against the JAX package's (CPU; cv2, h5py and
imageio are here).

* ``data/undistort.py`` and ``NYU_v2``: at NYU's own case, the intrinsics of
  ``_NYU_INTRINSICS_LINE`` and 640x480 frames, the optimal new camera matrix
  and ROI equal cv2's, the float maps within 1e-3 px of cv2's, the remap
  bit-equal to ``cv2.remap`` on random images; ``NYU_v2`` samples (2-frame
  stacks from seeded PNGs, resampled by index) against the JAX ``NYU_v2``:
  ``K_ms``/``K_inv_ms`` equal in float32, the images equal on at least
  99.9% of values and within 1/255 everywhere (all of them equal, bit for
  bit, with cv2 5.0 here);
* ``NYU_Prepare`` against the JAX preparer on a raw ``.ppm`` tree from a
  seed (one frame truncated), with ``splits.mat`` written by
  ``scipy.io.savemat`` and a small ``nyu_depth_v2_labeled.mat`` holding a
  ``scenes`` reference array written by ``h5py``: ``train.txt`` and
  ``calib_cam_to_cam.txt`` byte-equal, every PNG's decoded pixels equal.
"""

import os

import cv2
import h5py
import numpy as np
import pytest
import scipy.io

from unopticalflow_tpu.data import datasets as jds
from unopticalflow_tpu.data import preparers as jprep
from unopticalflow_tpu_torch.data import NYU_v2, preparers, undistort
from unopticalflow_tpu_torch.utils import imageio

NYU_K = np.array([[5.1885790117450188e+02, 0.0, 3.2558244941119034e+02],
                  [0.0, 5.1946961112127485e+02, 2.5373616633400465e+02],
                  [0.0, 0.0, 1.0]])
NYU_HW = (480, 640)


def test_undistortion_matches_cv2():
    d = NYU_v2.UNDIST_COEFF
    w_h = NYU_HW[::-1]
    new_k, roi = undistort.optimal_new_camera_matrix(NYU_K, d, w_h)
    want_k, want_roi = cv2.getOptimalNewCameraMatrix(NYU_K, d, w_h, 1, w_h)
    np.testing.assert_allclose(new_k, want_k, rtol=1e-12, atol=1e-9)
    assert roi == tuple(want_roi)
    mx, my = undistort.init_undistort_rectify_map(NYU_K, d, new_k, w_h)
    cx, cy = cv2.initUndistortRectifyMap(NYU_K, d, None, want_k, w_h, 5)
    assert mx.dtype == my.dtype == np.float32 and mx.shape == NYU_HW
    assert max(np.abs(mx - cx).max(), np.abs(my - cy).max()) <= 1e-3
    rng = np.random.RandomState(0)
    remap = undistort.LinearRemap(cx, cy, NYU_HW)
    for img in (rng.randint(0, 256, NYU_HW + (3,)).astype(np.uint8),
                cv2.GaussianBlur(rng.randint(0, 256, NYU_HW + (3,)).astype(np.uint8), (9, 9), 3),
                rng.randint(0, 256, NYU_HW).astype(np.uint8)):
        np.testing.assert_array_equal(remap(img), cv2.remap(img, cx, cy, cv2.INTER_LINEAR))
    # positions on every 1/32 of a pixel and outside the image's border
    fy, fx = np.divmod(np.arange(64 * 64).reshape(64, 64), 32)
    px = (-1.5 + np.arange(64)[None, :] % 24 + fx / 32.0).astype(np.float32)
    py = (-1.5 + np.arange(64)[:, None] % 20 + (fy % 32) / 32.0).astype(np.float32)
    small = rng.randint(0, 256, (20, 22, 3)).astype(np.uint8)
    np.testing.assert_array_equal(undistort.LinearRemap(px, py, (20, 22))(small),
                                  cv2.remap(small, px, py, cv2.INTER_LINEAR))


def _nyu_prepared(root, n=3):
    """A prepared NYU tree: ``n`` 2-frame stacks of 640x480 frames from a seed."""
    rng = np.random.RandomState(1)
    (root / "s").mkdir(parents=True)
    lines = []
    for i in range(n):
        noise = rng.randint(0, 256, (2 * NYU_HW[0], NYU_HW[1], 3)).astype(np.uint8)
        imageio.imwrite(str(root / "s" / f"{i:04d}.png"), cv2.GaussianBlur(noise, (5, 5), 1))
        lines.append(f"s/{i:04d}.png calib_cam_to_cam.txt\n")
    (root / "train.txt").write_text("".join(lines))
    (root / "calib_cam_to_cam.txt").write_text(jprep._NYU_INTRINSICS_LINE)
    return root


@pytest.mark.parametrize("img_hw", [(192, 256), (448, 576)])
def test_nyu_v2_samples_match_jax(tmp_path, img_hw):
    root = _nyu_prepared(tmp_path / "nyu")
    port = NYU_v2(str(root), num_scales=3, img_hw=img_hw, num_iterations=4)
    ref = jds.NYU_v2(str(root), num_scales=3, img_hw=img_hw, num_iterations=4)
    equal = total = 0
    for i in range(len(ref)):
        img, k_ms, k_inv = port[i]
        w_img, w_k, w_inv = ref[i]
        assert img.dtype == k_ms.dtype == k_inv.dtype == np.float32
        assert img.shape == w_img.shape == (2 * img_hw[0], img_hw[1], 3)
        assert k_ms.shape == (3, 3, 3)
        np.testing.assert_array_equal(k_ms, w_k)
        np.testing.assert_array_equal(k_inv, w_inv)
        assert np.abs(img - w_img).max() <= 1.0 / 255 + 1e-7
        equal += int((img == w_img).sum())
        total += img.size
    assert equal >= 0.999 * total
    assert equal == total  # the count reached: every value bit-equal
    assert port._maps[1] == tuple(ref._maps[2])  # the ROI
    mx, my = undistort.init_undistort_rectify_map(
        NYU_K, NYU_v2.UNDIST_COEFF,
        undistort.optimal_new_camera_matrix(NYU_K, NYU_v2.UNDIST_COEFF, NYU_HW[::-1])[0],
        NYU_HW[::-1])
    assert max(np.abs(mx - ref._maps[0]).max(), np.abs(my - ref._maps[1]).max()) <= 1e-3


def _ppm(path, img, truncate=False):
    data = b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]) + img.tobytes()
    path.write_bytes(data[:len(data) // 2] if truncate else data)


def _raw_nyu_tree(root):
    """Raw ``.ppm`` scene dirs and the labeled set's scene names and split."""
    rng = np.random.RandomState(2)
    raw, test = root / "raw", root / "test"
    folders = {"d0/bedroom_0001": 14, "d0/bedroom_0001b": 13, "d1/kitchen_0002": 14,
               "d1/office_0003": 12}
    for folder, n in folders.items():
        (raw / folder).mkdir(parents=True)
        for i in range(n):
            img = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
            # a truncated frame mid-scene, and the scene's (dropped) last one
            bad = (folder == "d0/bedroom_0001" and i == 1) or i == n - 1
            _ppm(raw / folder / f"r-{1000 + i:06d}.ppm", img, truncate=bad)
        (raw / folder / "INDEX.txt").write_text("not a frame\n")
    test.mkdir()
    names = ["bedroom_0001", "kitchen_0002", "office_0003"]
    labeled = [0, 0, 1, 2, 1, 2]  # the scene of each labeled frame
    with h5py.File(test / "nyu_depth_v2_labeled.mat", "w") as f:
        grp = f.create_group("refs")
        refs = []
        for k, name in enumerate(names):
            refs.append(grp.create_dataset(f"n{k}", data=np.array([ord(c) for c in name],
                                                                  np.uint16)).ref)
        scenes = f.create_dataset("scenes", (1, len(labeled)), dtype=h5py.ref_dtype)
        for j, s in enumerate(labeled):
            scenes[0, j] = refs[s]
    scipy.io.savemat(str(test / "splits.mat"), {"trainNdxs": np.array([[1], [3], [5]]),
                                                "testNdxs": np.array([[4], [6]])})
    return str(raw), str(test)


def test_nyu_prepare_matches_jax(tmp_path):
    raw, test = _raw_nyu_tree(tmp_path)
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    port = preparers.NYU_Prepare(raw, test)
    ref = jprep.NYU_Prepare(raw, test)
    assert port.get_train_scenes() == ref.get_train_scenes() == ["bedroom_0001", "kitchen_0002"]
    assert port.get_test_scenes() == ref.get_test_scenes() == ["office_0003"]
    port.prepare_data_mp(str(port_out), stride=10, num_processes=2)
    ref.prepare_data_mp(str(jax_out), stride=10, num_processes=2)
    for name in ("train.txt", "calib_cam_to_cam.txt"):
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes(), name
    lines = (port_out / "train.txt").read_text().splitlines()
    # stride 10 over each scene's frames less its last: bedroom_0001 3 less
    # the snippet from its truncated frame, bedroom_0001b 2, kitchen 3; no office
    assert len(lines) == 2 + 2 + 3 and not any("office" in ln for ln in lines)
    for ln in lines:
        rel = ln.split()[0]
        got = imageio.imread(str(port_out / rel))
        want = cv2.imread(str(jax_out / rel))
        assert got.shape == (48, 32, 3)
        np.testing.assert_array_equal(got, want)
        # the file holds the frames' RGB order, as the JAX worker writes it
        first = imageio.read_ppm(os.path.join(raw, os.path.dirname(rel),
                                              os.path.basename(rel)[:-4] + ".ppm"))
        np.testing.assert_array_equal(got[:24, :, ::-1], first)


def test_read_ppm_refuses_what_it_does_not_read(tmp_path):
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    p = tmp_path / "a.ppm"
    p.write_bytes(b"P6\n# a comment\n3 2\n255\n" + img.tobytes())
    np.testing.assert_array_equal(imageio.read_ppm(str(p)), img)
    for bad, match in ((b"P6\n3 2\n255\n" + img.tobytes()[:5], "truncated"),
                       (b"P5\n3 2\n255\n" + img.tobytes(), "P6"),
                       (b"P6\n3 2\n65535\n" + img.tobytes() * 2, "maxval")):
        p.write_bytes(bad)
        with pytest.raises(ValueError, match=match):
            imageio.read_ppm(str(p))
