"""Host-side training and evaluation datasets over prepared directories.

The port's copy of ``unopticalflow_tpu/data/datasets.py`` (numpy; PNGs are
read and resized by ``utils/imageio.py``, as cv2 reads and resizes them): a
``train.txt`` manifest of vertically stacked PNGs, per-frame resize to ``img_hw``, a joint horizontal
flip, /255 normalisation, intrinsics, and the reference's idx-seeded
resampling (``np.random.RandomState(idx)`` then a uniform draw), which makes
every sample a pure function of its index, so the loader's threads decode in
parallel with identical results.  Samples are channels-last, (frames * H,
W, 3), as the port's training forward takes them.
"""

from __future__ import annotations

import os

import numpy as np

from unopticalflow_tpu_torch.utils import imageio


def _imread(path):
    img = imageio.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _resize(img, wh):
    return imageio.resize(img, wh)


def _maybe_flip(img, rng):
    """Joint horizontal flip of the whole stack with probability 0.5."""
    if rng.rand() > 0.5:
        return img[:, ::-1]
    return img


class StackedFrameDataset:
    """Base: a ``train.txt`` manifest of vertically stacked ``num_frames`` PNGs.

    ``cache_dir``: optional directory of decoded-and-resized uint8 ``.npy``
    copies, filled at first access, so repeat visits (guaranteed by the
    idx-seeded resampling over a finite dataset) are mmap reads instead of
    PNG decodes.  The flip stays per index, after the cache.
    """

    num_frames = 3
    has_intrinsics = True

    def __init__(
        self,
        data_dir,
        num_scales=3,
        img_hw=(256, 832),
        num_iterations=None,
        cache_dir=None,
        return_intrinsics=False,
        emit_uint8=False,
    ):
        self.data_dir = data_dir
        self.num_scales = num_scales
        self.img_hw = tuple(img_hw)
        self.num_iterations = num_iterations
        self.cache_dir = cache_dir
        # emit_uint8: __getitem__ returns the decoded, resized (and flipped)
        # stack as uint8 and the /255 cast happens on the device
        # (training/train_step.py::loss_fn): the same values, 4x fewer bytes
        self.emit_uint8 = emit_uint8
        # return_intrinsics: (img, K, K_inv) at network resolution, with no
        # flip (a flip would mirror the principal point and negate flow-u)
        self.return_intrinsics = return_intrinsics
        if return_intrinsics and not self.has_intrinsics:
            raise ValueError(
                f"{type(self).__name__} has no calibration files; flowposenet "
                "needs a dataset with intrinsics"
            )
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self.data_list = self.get_data_list(os.path.join(data_dir, "train.txt"))

    # -- manifest ----------------------------------------------------------
    def get_data_list(self, info_file):
        with open(info_file, "r") as f:
            lines = f.readlines()
        data_list = []
        for line in lines:
            k = line.strip("\n").split()
            data = {"image_file": os.path.join(self.data_dir, k[0])}
            if len(k) > 1:
                data["cam_intrinsic_file"] = os.path.join(self.data_dir, k[1])
            data_list.append(data)
        print(f"A total of {len(data_list)} image pairs found")
        return data_list

    def count(self):
        return len(self.data_list)

    def rand_num(self, idx):
        """Deterministic idx -> sample index (the reference's resampling)."""
        rng = np.random.RandomState(idx)
        return rng.randint(self.count()), rng

    def __len__(self):
        return self.num_iterations if self.num_iterations is not None else self.count()

    # -- preprocessing -----------------------------------------------------
    def resize_img(self, img, img_hw):
        """Split the stack, resize each frame, restack."""
        n = self.num_frames
        h = img.shape[0] // n
        frames = [
            _resize(img[i * h : (i + 1) * h], (img_hw[1], img_hw[0]))
            for i in range(n)
        ]
        return np.concatenate(frames, 0)

    def preprocess_img(self, img, img_hw=None, is_test=False, rng=None):
        img_hw = img_hw or self.img_hw
        img = self.resize_img(img, img_hw)
        if not is_test:
            img = _maybe_flip(img, rng or np.random)
        return np.ascontiguousarray(img, dtype=np.float32) / 255.0

    # -- intrinsics --------------------------------------------------------
    def read_cam_intrinsic(self, fname):
        with open(fname, "r") as f:
            lines = f.readlines()
        data = [float(k) for k in lines[-1].strip("\n").split(" ")[1:]]
        return np.array(data).reshape(3, 4)[:3, :3]

    # -- items ---------------------------------------------------------------
    def _resized_uint8(self, sample_idx):
        """Decoded + resized (pre-augmentation) uint8 stack, cached if asked."""
        import hashlib
        import threading
        import uuid

        data = self.data_list[sample_idx]
        if self.cache_dir is None:
            return self.resize_img(_imread(data["image_file"]), self.img_hw)
        h, w = self.img_hw
        # keyed by source path, not index: a regenerated train.txt in the
        # same data_dir misses instead of serving stale frames
        tag = hashlib.sha1(data["image_file"].encode()).hexdigest()[:16]
        cache = os.path.join(self.cache_dir, f"{tag}_{h}x{w}.npy")
        if os.path.exists(cache):
            return np.load(cache, mmap_mode="r")
        img = self.resize_img(_imread(data["image_file"]), self.img_hw)
        # a temporary file per writer: loader threads share a PID and may
        # fill the same entry at once
        tmp = f"{cache}.tmp{os.getpid()}.{threading.get_ident()}.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:  # np.save(path) would append .npy to tmp
            np.save(f, img.astype(np.uint8))
        os.replace(tmp, cache)  # atomic; a loser overwrites equal bytes
        return img

    def _orig_frame_wh(self, image_file):
        """(W, H per frame) of the stacked source PNG, from its IHDR header."""
        if not hasattr(self, "_wh_cache"):
            self._wh_cache = {}
        if image_file not in self._wh_cache:
            with open(image_file, "rb") as f:
                head = f.read(24)
            w = int.from_bytes(head[16:20], "big")
            h = int.from_bytes(head[20:24], "big")
            self._wh_cache[image_file] = (w, h // self.num_frames)
        return self._wh_cache[image_file]

    def sample_intrinsics(self, idx):
        """Per-sample (K, K_inv) rescaled to the network resolution:
        fx/cx by the width ratio, fy/cy by the height ratio."""
        data = self.data_list[idx]
        K = self.read_cam_intrinsic(data["cam_intrinsic_file"]).copy()
        ow, oh = self._orig_frame_wh(data["image_file"])
        K[0, :] *= self.img_hw[1] / ow
        K[1, :] *= self.img_hw[0] / oh
        return K.astype(np.float32), np.linalg.inv(K).astype(np.float32)

    def __getitem__(self, idx):
        """(num_frames * H, W, 3) float32 in [0, 1] (uint8 with
        ``emit_uint8``); with ``return_intrinsics``: (img, K, K_inv)."""
        rng = None
        if self.num_iterations is not None:
            if idx >= self.num_iterations:
                raise IndexError(idx)
            idx, rng = self.rand_num(idx)
        raw = self._resized_uint8(idx)
        if self.return_intrinsics:
            K, K_inv = self.sample_intrinsics(idx)
            if self.emit_uint8:
                return np.ascontiguousarray(raw, dtype=np.uint8), K, K_inv
            return np.ascontiguousarray(raw, dtype=np.float32) / 255.0, K, K_inv
        img = _maybe_flip(raw, rng or np.random)
        if self.emit_uint8:
            return np.ascontiguousarray(img, dtype=np.uint8)
        return np.ascontiguousarray(img, dtype=np.float32) / 255.0


class KITTI_Prepared(StackedFrameDataset):
    """KITTI raw/odometry prepared 3-frame dataset."""

    num_frames = 3


class SINTEL_Prepared(StackedFrameDataset):
    """Sintel prepared 3-frame dataset, no intrinsics."""

    num_frames = 3
    has_intrinsics = False


class NYU_v2(StackedFrameDataset):
    """NYUv2 prepared 2-frame dataset with lens undistortion.

    Returns (img, K_ms, K_inv_ms): the (2H, W, 3) float32 stack in [0, 1],
    undistorted (``data/undistort.py``: cv2's optimal new camera at alpha 1,
    its maps and bilinear remap, then the valid ROI), no flip; the
    (num_scales, 3, 3) float32 intrinsics and inverses at each scale.  As in
    the JAX package, the intrinsics are rescaled from the source size by the
    height ratio in x and the width ratio in y (the reference's
    ``rescale_intrinsics``), and the maps of the first sample serve all.
    """

    num_frames = 2
    UNDIST_COEFF = np.array(
        [2.07966153e-01, -5.8613825e-01, 7.223136313e-04, 1.047962719e-03, 4.98569866e-01]
    )

    def __init__(self, data_dir, num_scales=3, img_hw=(448, 576), num_iterations=None):
        super().__init__(data_dir, num_scales, img_hw, num_iterations)
        self._maps = None  # (LinearRemap, roi), built at the first sample

    def rescale_intrinsics(self, K, img_hw_orig, img_hw_new):
        K = K.copy()
        K[0, :] *= img_hw_new[0] / img_hw_orig[0]
        K[1, :] *= img_hw_new[1] / img_hw_orig[1]
        return K

    def get_multiscale_intrinsics(self, K, num_scales):
        ks = []
        for s in range(num_scales):
            k = K.copy()
            k[0, :] /= 2**s
            k[1, :] /= 2**s
            ks.append(k)
        return np.stack(ks, 0), np.stack([np.linalg.inv(k) for k in ks], 0)

    def undistort_img(self, img, K):
        from unopticalflow_tpu_torch.data import undistort

        h2 = img.shape[0] // 2
        h, w = h2, img.shape[1]
        if self._maps is None:
            new_k, roi = undistort.optimal_new_camera_matrix(K, self.UNDIST_COEFF, (w, h))
            mapx, mapy = undistort.init_undistort_rectify_map(K, self.UNDIST_COEFF, new_k,
                                                              (w, h))
            self._maps = (undistort.LinearRemap(mapx, mapy, (h, w)), roi)
        remap, (x, y, rw, rh) = self._maps
        out = [remap(i)[y:y + rh, x:x + rw] for i in (img[:h2], img[h2:])]
        return np.concatenate(out, 0)

    def __getitem__(self, idx):
        if self.num_iterations is not None:
            if idx >= self.num_iterations:
                raise IndexError(idx)
            idx, _ = self.rand_num(idx)
        data = self.data_list[idx]
        img = _imread(data["image_file"])
        img_hw_orig = (img.shape[0] // 2, img.shape[1])
        K_orig = self.read_cam_intrinsic(data["cam_intrinsic_file"])
        K = self.rescale_intrinsics(K_orig, img_hw_orig, self.img_hw)
        K_ms, K_inv_ms = self.get_multiscale_intrinsics(K, self.num_scales)
        img = self.undistort_img(img, K_orig)
        img = self.resize_img(img, self.img_hw).astype(np.float32) / 255.0
        return img, K_ms.astype(np.float32), K_inv_ms.astype(np.float32)


class KITTI_2012(StackedFrameDataset):
    """KITTI 2012 evaluation pairs: ``image_2/%06d_10|_11.png``."""

    num_frames = 2
    num_total = 194

    def __init__(self, data_dir, img_hw=(256, 832)):
        self.data_dir = data_dir
        self.img_hw = tuple(img_hw)
        self.num_scales = 3
        self.num_iterations = None
        self.data_list = self.get_data_list()

    def get_data_list(self):
        return [
            {
                "img1_dir": os.path.join(self.data_dir, "image_2", f"{i:06d}_10.png"),
                "img2_dir": os.path.join(self.data_dir, "image_2", f"{i:06d}_11.png"),
                "calib_file_dir": os.path.join(
                    self.data_dir, "calib_cam_to_cam", f"{i:06d}.txt"
                ),
            }
            for i in range(self.num_total)
        ]

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx):
        """(2H, W, 3) float32 pair stack, no flip."""
        data = self.data_list[idx]
        img = np.concatenate(
            [_imread(data["img1_dir"]), _imread(data["img2_dir"])], 0
        )
        return self.preprocess_img(img, self.img_hw, is_test=True)


class KITTI_2015(KITTI_2012):
    """KITTI 2015 evaluation pairs (200 frames)."""

    num_total = 200
