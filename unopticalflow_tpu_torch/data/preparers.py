"""Raw-dataset preparers: stacked-frame PNGs and ``train.txt`` manifests.

The port's copy of ``KITTI_RAW``, ``KITTI_Odo`` and ``SINTEL_RAW`` from
``unopticalflow_tpu/data/preparers.py``, with the prepared tree's layout
kept exactly (stacked-frame PNGs, a ``train.txt`` per folder and a global
one, copied calibration files), so trees prepared by either package are
interchangeable:

* ``KITTI_RAW``: 3-frame vertical stacks, skipping Eigen's static frames and
  test scenes;
* ``KITTI_Odo``: 2-frame stacks of odometry sequences 00-08 with their
  ``calib.txt``;
* ``SINTEL_RAW``: 3-frame stacks of each scene's sorted files, with a
  stride, no calibration.

Frames are read and written by ``utils/imageio.py`` (cv2's ``imread``
exactly; the writer filters rows as libpng does), so the preparers run
without opencv.  A ``multiprocessing.Pool`` of spawned processes takes one
folder at a time.  The global ``train.txt`` is written last: it is what the
trainer looks for to know that the tree is complete.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import shutil

import numpy as np

from unopticalflow_tpu_torch.utils import imageio


def _stack(paths):
    """The frames of ``paths`` stacked vertically, or None if one is missing."""
    frames = [imageio.imread(p) for p in paths]
    if any(f is None for f in frames):
        return None
    return np.concatenate(frames, 0).astype(np.uint8)


def _concat_manifests(output_dir: str, folder_manifests: list[str]):
    with open(os.path.join(output_dir, "train.txt"), "w") as f:
        for m in folder_manifests:
            if os.path.isfile(m):
                with open(m) as g:
                    f.write(g.read())


def _run_pool(worker, folders, num_processes: int) -> None:
    """``worker`` on every folder, one folder a task, in spawned processes
    (no more than there are folders: each imports the package anew)."""
    n = max(1, min(num_processes, len(folders)))
    with multiprocessing.get_context("spawn").Pool(n) as pool:
        pool.map(worker, folders)


# ---------------------------------------------------------------------------
# KITTI raw
# ---------------------------------------------------------------------------


def _kitti_raw_worker(folder, data_dir, output_dir, stride, static_frames, test_scenes):
    scene = folder.split("/")[1]
    if scene[:-5] in test_scenes:
        return None
    static_ids = set(static_frames.get(folder, []))
    image_path = os.path.join(data_dir, folder, "image_02/data")
    dump = os.path.join(output_dir, folder)
    names = sorted(os.listdir(image_path))
    date = folder.split("/")[0]
    os.makedirs(dump, exist_ok=True)
    lines = []
    for n in range(len(names) - 2 * stride):
        ids = [f"{n:010d}", f"{n + stride:010d}", f"{n + 2 * stride:010d}"]
        if any(i in static_ids for i in ids):
            continue
        img = _stack([os.path.join(image_path, i + ".png") for i in ids])
        if img is None:
            continue
        imageio.imwrite(os.path.join(dump, ids[0] + ".png"), img)
        lines.append(f"{os.path.join(folder, ids[0] + '.png')} "
                     f"{os.path.join(date, 'calib_cam_to_cam.txt')}\n")
    with open(os.path.join(dump, "train.txt"), "w") as f:
        f.writelines(lines)
    return folder


class KITTI_RAW:
    """KITTI-raw 3-frame snippets: ``<date>/<drive>/image_02/data/*.png``."""

    def __init__(self, data_dir, static_frames_txt, test_scenes_txt):
        self.data_dir = data_dir
        self.static_frames_txt = static_frames_txt
        self.test_scenes_txt = test_scenes_txt

    def collect_static_frame(self) -> dict:
        static = {}
        with open(self.static_frames_txt) as f:
            for line in f:
                date, drive, frame_id = line.strip().split(" ")
                static.setdefault(os.path.join(date, drive), []).append(f"{int(frame_id):010d}")
        return static

    def collect_test_scenes(self) -> list:
        with open(self.test_scenes_txt) as f:
            return [line.strip() for line in f]

    def prepare_data_mp(self, output_dir, stride=1, num_processes=16):
        if not os.path.isfile(os.path.join(output_dir, "train.txt")):
            os.makedirs(output_dir, exist_ok=True)
            folders = [os.path.join(d, s)
                       for d in sorted(os.listdir(self.data_dir))
                       for s in sorted(os.listdir(os.path.join(self.data_dir, d)))
                       if os.path.isdir(os.path.join(self.data_dir, d, s))]
            _run_pool(functools.partial(
                _kitti_raw_worker, data_dir=self.data_dir, output_dir=output_dir,
                stride=stride, static_frames=self.collect_static_frame(),
                test_scenes=self.collect_test_scenes()), folders, num_processes)

        for date in sorted(os.listdir(self.data_dir)):
            src = os.path.join(self.data_dir, date, "calib_cam_to_cam.txt")
            dst_dir = os.path.join(output_dir, date)
            if os.path.isfile(src) and os.path.isdir(dst_dir):
                shutil.copy(src, os.path.join(dst_dir, "calib_cam_to_cam.txt"))

        manifests = []
        for date in sorted(os.listdir(output_dir)):
            date_dir = os.path.join(output_dir, date)
            if os.path.isdir(date_dir):
                manifests += [os.path.join(date_dir, d, "train.txt")
                              for d in sorted(os.listdir(date_dir))]
        _concat_manifests(output_dir, manifests)
        print("Data Preparation Finished.")


# ---------------------------------------------------------------------------
# KITTI odometry
# ---------------------------------------------------------------------------


def _kitti_odo_worker(folder, data_dir, output_dir, stride):
    image_path = os.path.join(data_dir, folder, "image_2")
    dump = os.path.join(output_dir, folder)
    os.makedirs(dump, exist_ok=True)
    names = sorted(os.listdir(image_path))
    lines = []
    for n in range(len(names) - stride):
        ids = [f"{n:06d}", f"{n + stride:06d}"]
        img = _stack([os.path.join(image_path, i + ".png") for i in ids])
        if img is None:
            continue
        imageio.imwrite(os.path.join(dump, ids[0] + ".png"), img)
        lines.append(f"{os.path.join(folder, ids[0] + '.png')} "
                     f"{os.path.join(folder, 'calib.txt')}\n")
    with open(os.path.join(dump, "train.txt"), "w") as f:
        f.writelines(lines)


class KITTI_Odo:
    """KITTI odometry 2-frame snippets of sequences 00-08."""

    TRAIN_SEQS = ("00", "01", "02", "03", "04", "05", "06", "07", "08")

    def __init__(self, data_dir):
        self.data_dir = data_dir

    def prepare_data_mp(self, output_dir, stride=1, num_processes=16):
        if not os.path.isfile(os.path.join(output_dir, "train.txt")):
            os.makedirs(output_dir, exist_ok=True)
            folders = [d for d in sorted(os.listdir(self.data_dir)) if d in self.TRAIN_SEQS]
            _run_pool(functools.partial(_kitti_odo_worker, data_dir=self.data_dir,
                                        output_dir=output_dir, stride=stride),
                      folders, num_processes)

        for d in self.TRAIN_SEQS:
            src = os.path.join(self.data_dir, d, "calib.txt")
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(output_dir, d, "calib.txt"))
        _concat_manifests(output_dir,
                          [os.path.join(output_dir, d, "train.txt") for d in self.TRAIN_SEQS])
        print("Data Preparation Finished.")


# ---------------------------------------------------------------------------
# Sintel
# ---------------------------------------------------------------------------


def _sintel_worker(folder, data_dir, output_dir, stride):
    image_path = os.path.join(data_dir, folder)
    dump = os.path.join(output_dir, folder)
    os.makedirs(dump, exist_ok=True)
    names = sorted(os.listdir(image_path))
    lines = []
    for n in range(len(names) - 2 * stride):
        trip = [names[n], names[n + stride], names[n + 2 * stride]]
        img = _stack([os.path.join(image_path, t) for t in trip])
        if img is None:
            continue
        imageio.imwrite(os.path.join(dump, f"{n:010d}.png"), img)
        lines.append(f"{os.path.join(folder, f'{n:010d}.png')}\n")
    with open(os.path.join(dump, "train.txt"), "w") as f:
        f.writelines(lines)


class SINTEL_RAW:
    """Sintel 3-frame snippets of each scene directory's sorted frames."""

    def __init__(self, data_dir):
        self.data_dir = data_dir

    def prepare_data_mp(self, output_dir, stride=1, num_processes=8):
        if not os.path.isfile(os.path.join(output_dir, "train.txt")):
            os.makedirs(output_dir, exist_ok=True)
            folders = [d for d in sorted(os.listdir(self.data_dir))
                       if os.path.isdir(os.path.join(self.data_dir, d))]
            _run_pool(functools.partial(_sintel_worker, data_dir=self.data_dir,
                                        output_dir=output_dir, stride=stride),
                      folders, num_processes)

        manifests = [os.path.join(output_dir, d, "train.txt")
                     for d in sorted(os.listdir(output_dir))
                     if os.path.isdir(os.path.join(output_dir, d))]
        _concat_manifests(output_dir, manifests)
        print("Data Preparation Finished.")
