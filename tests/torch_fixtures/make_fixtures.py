"""Writes the fixtures of ``chip_smoke.py`` phase 17 and
``tests/test_torch_jpeg.py``: JPEG files with cv2's decodes, and a
MATLAB-layout NYUv2 labeled set with what the JAX package reads from it.

    python tests/torch_fixtures/make_fixtures.py

It needs cv2, h5py, scipy and the JAX package (the card's machine has none
of them, so the files are committed): OpenCV 5.0.0 with libjpeg-turbo
3.1.2 wrote and decoded the JPEGs, h5py 3.14 the ``.mat``.  Every file is
made from a seed.

* ``jpeg/<name>.jpg``: baseline JPEGs (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and
  grey, qualities 10 to 100, a restart interval, optimised Huffman tables,
  an odd size, an Exif orientation), each beside ``<name>.png``, cv2's
  ``IMREAD_COLOR`` decode written by the port's ``encode_png``; a 512x832
  stacked pair and its two 256x832 frames (4:2:0, quality 90); and
  ``progressive.jpg``, which the port refuses.
* ``nyu/nyu_depth_v2_labeled.mat``: a 512-byte MATLAB user block; chunked,
  deflated ``images`` (3, 3, 640, 480) uint8 and ``depths`` (3, 640, 480)
  float32 of smooth content; ``scenes`` (1, 3) references to (L, 1) uint16
  char datasets under ``#refs#``.  ``nyu/splits.mat`` (scipy, MATLAB v5).
  ``nyu/expected.json``: the SHA-256 of the arrays the JAX package's
  ``load_nyu_test_data`` returns, its ``eval_depth`` and ``eval_mask`` on
  ``chip_smoke.depth_mask_inputs(17)``, and the SHA-256 of the pixels of
  ``eval_mask``'s PNGs.
"""

import hashlib
import json
import os
import struct
import sys
import tempfile
import types

import cv2
import h5py
import numpy as np
import scipy.io

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

from chip_smoke import depth_mask_inputs  # noqa: E402
from unopticalflow_tpu_torch.utils import imageio  # noqa: E402

SEED = 17
NYU_SCENES = ["bedroom_0001", "kitchen_0002", "office_0003"]


def smooth(rng, h, w, ch=3, blur=9):
    img = rng.randint(0, 256, (h, w, ch)).astype(np.uint8)
    return cv2.GaussianBlur(img, (0, 0), blur).reshape(h, w, ch)


def exif_segment(orientation: int) -> bytes:
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def jpeg_fixtures(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(SEED)
    img = smooth(rng, 48, 64, blur=3)
    noise = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    sf = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}") for k in
          ("444", "422", "420", "440", "411")}
    q, s = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    cases = {
        "s444_q90": (img, [q, 90, s, sf["444"]]),
        "s422_q75": (img, [q, 75, s, sf["422"]]),
        "s420_q50": (img, [q, 50, s, sf["420"]]),
        "s440_q95": (img, [q, 95, s, sf["440"]]),
        "s411_q60": (img, [q, 60, s, sf["411"]]),
        "grey_q85": (img[:, :, 1], [q, 85]),
        "s420_q10": (img, [q, 10, s, sf["420"]]),
        "s444_q100_noise": (noise, [q, 100, s, sf["444"]]),
        "s420_rst2": (img, [q, 80, s, sf["420"], cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
        "s422_optimized": (img, [q, 70, s, sf["422"], cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
        "odd_17x31_420": (img[:17, :31], [q, 85, s, sf["420"]]),
    }
    files = {}
    for name, (src, params) in cases.items():
        files[name] = cv2.imencode(".jpg", src, params)[1].tobytes()
    base = cv2.imencode(".jpg", img[:, :40], [q, 90, s, sf["420"]])[1].tobytes()
    files["exif6_420"] = base[:2] + exif_segment(6) + base[2:]
    # the served pair and the demo's frames: a smooth scene and the same
    # scene moved 3 px right and 2 px down
    scene = smooth(rng, 262, 840, blur=6)
    a, b = scene[2:258, 3:835], scene[:256, :832]
    files["frame_a"] = cv2.imencode(".jpg", a, [q, 90, s, sf["420"]])[1].tobytes()
    files["frame_b"] = cv2.imencode(".jpg", b, [q, 90, s, sf["420"]])[1].tobytes()
    files["pair_512x832"] = cv2.imencode(".jpg", np.concatenate([a, b], 0),
                                         [q, 90, s, sf["420"]])[1].tobytes()
    for name, data in files.items():
        with open(os.path.join(out, name + ".jpg"), "wb") as f:
            f.write(data)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        imageio.imwrite(os.path.join(out, name + ".png"), want)
    with open(os.path.join(out, "progressive.jpg"), "wb") as f:
        f.write(cv2.imencode(".jpg", img, [q, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes())


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def nyu_fixtures(out: str) -> None:
    from unopticalflow_tpu.evaluation import depth_harness, eval_depth, eval_mask

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(SEED + 1)
    n = len(NYU_SCENES)
    yy, xx = np.mgrid[0:640, 0:480].astype(np.float64)
    images = np.stack([np.transpose(smooth(rng, 640, 480, blur=12), (2, 0, 1))
                       for _ in range(n)])
    depths = np.stack([np.round((3.0 + np.sin(xx / 60.0 + k) + 0.5 * np.cos(yy / 45.0)) * 64)
                       / 64 for k in range(n)]).astype(np.float32)
    path = os.path.join(out, "nyu_depth_v2_labeled.mat")
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("images", data=images, chunks=(1, 3, 160, 120), compression="gzip",
                         compression_opts=9)
        f.create_dataset("depths", data=depths, chunks=(1, 160, 120), compression="gzip",
                         compression_opts=9)
        grp = f.create_group("#refs#")
        refs = [grp.create_dataset(f"s{k}", data=np.array([[ord(c)] for c in nm], np.uint16)).ref
                for k, nm in enumerate(NYU_SCENES)]
        scenes = f.create_dataset("scenes", (1, n), dtype=h5py.ref_dtype)
        scenes[0, :] = refs
    with open(path, "r+b") as fh:
        fh.write(b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created by: make_fixtures.py "
                 b"HDF5 schema 1.00 .".ljust(128, b" "))
    scipy.io.savemat(os.path.join(out, "splits.mat"),
                     {"trainNdxs": np.array([[1], [2]]), "testNdxs": np.array([[3]])})
    test_images, test_depths = depth_harness.load_nyu_test_data(out)

    gts, preds, masks, gt_masks = depth_mask_inputs(SEED)
    depth_res = [float(v) for v in eval_depth(gts, preds)]
    depth_res_nyu = [float(v) for v in eval_depth(gts, preds, nyu=True)]
    with tempfile.TemporaryDirectory() as tmp:
        mask_res = eval_mask(masks, gt_masks, types.SimpleNamespace(trace=tmp))
        pngs = {}
        for name in sorted(os.listdir(os.path.join(tmp, "pred_mask"))):
            px = cv2.imread(os.path.join(tmp, "pred_mask", name), cv2.IMREAD_UNCHANGED)
            pngs[name] = digest(px)
    expected = {
        "train_scenes": NYU_SCENES[:2],
        "test_scenes": NYU_SCENES[2:],
        "test_images_sha256": digest(test_images),
        "test_depths_sha256": digest(test_depths),
        "test_shapes": [list(test_images.shape), list(test_depths.shape)],
        "eval_depth": depth_res,
        "eval_depth_nyu": depth_res_nyu,
        "eval_mask": [float(v) for v in mask_res[:4]] + [[float(v) for v in mask_res[4]]],
        "eval_mask_png_pixels_sha256": pngs,
    }
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    jpeg_fixtures(os.path.join(HERE, "jpeg"))
    nyu_fixtures(os.path.join(HERE, "nyu"))
