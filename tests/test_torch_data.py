"""The port's datasets and ground-truth readers against the JAX package's.

On a prepared directory of stacked 3-frame PNGs and on a KITTI 2015-shaped
tree (200 pairs, flow_occ/flow_noc 16-bit flow PNGs with invalid pixels,
obj_map), the 8-bit PNGs filtered row by row as libpng's heuristic
filters them (``utils/imageio.encode_png``: Sub, Up, Average and Paeth rows,
as in KITTI's own files; the cv2 build here writes Sub rows only) and the
flow PNGs by the JAX package's ``write_flow_png`` (cv2): the port's
``KITTI_Prepared`` and
``SINTEL_Prepared`` (``emit_uint8`` on and off, ``cache_dir`` on and off,
with ``num_iterations`` and without, with intrinsics), the evaluation pairs
of ``KITTI_2012``/``KITTI_2015``, ``load_gt_flow_kitti`` and
``load_gt_mask`` must equal the JAX package's (which read and resize with
cv2) bit for bit, dtype included, at the same indices; the port's
``BatchLoader`` must give the JAX loader's batches, in order.  Also the
producer thread that the loader and the learning harness share
(``data.loader.background``).
"""

import threading
import zlib

import numpy as np
import pytest

from unopticalflow_tpu.data import datasets as jax_datasets
from unopticalflow_tpu.data.loader import BatchLoader as JaxBatchLoader
from unopticalflow_tpu.evaluation.evaluate_flow import load_gt_flow_kitti as jax_gt_flow
from unopticalflow_tpu.evaluation.evaluate_mask import load_gt_mask as jax_gt_mask
from unopticalflow_tpu.evaluation.flowlib import write_flow_png
from unopticalflow_tpu_torch.data import datasets as port_datasets
from unopticalflow_tpu_torch.data.loader import BatchLoader, background
from unopticalflow_tpu_torch.evaluation import load_gt_flow_kitti, load_gt_mask
from unopticalflow_tpu_torch.utils import imageio

FRAME_HW = (40, 70)  # prepared source frames; the datasets resize to IMG_HW
IMG_HW = (64, 64)
N_SNIPPETS = 6
N_ITER = 12  # num_iterations: idx-seeded draws over the 6 snippets, with flips
KITTI_HW = (48, 80)  # the evaluation tree's frames and ground truth
EVAL_HW = (32, 64)
N_GT = 200  # KITTI 2015's frame count


def _row_filters(path) -> set:
    """The filter type of every row of an 8-bit RGB PNG (one IDAT stream)."""
    data = open(path, "rb").read()
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[r * (3 * w + 1)] for r in range(h)}


def _prepared(root, calib):
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    h, w = FRAME_HW
    lines = []
    for i in range(N_SNIPPETS):
        base = rng.randint(0, 255, (h + 4, w, 3)).astype(np.uint8)
        tri = np.concatenate([base[:h], base[2:h + 2], base[4:h + 4]], 0)
        (root / f"{i:010d}.png").write_bytes(imageio.encode_png(tri))
        lines.append(f"{i:010d}.png" + (" calib.txt" if calib else "") + "\n")
    if calib:
        (root / "calib.txt").write_text(
            "P_rect_02: 30.0 0.0 16.0 0.0 0.0 30.0 16.0 0.0 0.0 0.0 1.0 0.0\n")
    (root / "train.txt").write_text("".join(lines))
    assert _row_filters(root / "0000000000.png") >= {1, 2, 3, 4}
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    kitti = _prepared(root / "kitti_prepared", calib=True)
    sintel = _prepared(root / "sintel_prepared", calib=False)
    gt = root / "kitti2015"
    for sub in ("image_2", "flow_occ", "flow_noc", "obj_map"):
        (gt / sub).mkdir(parents=True)
    rng = np.random.RandomState(5)
    h, w = KITTI_HW
    for i in range(N_GT):
        for suffix in ("_10", "_11"):
            (gt / "image_2" / f"{i:06d}{suffix}.png").write_bytes(
                imageio.encode_png(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)))
        flow = np.zeros((h, w, 3))
        flow[:, :, :2] = np.round(rng.uniform(-40, 40, (h, w, 2)) * 64) / 64
        flow[:, :, 2] = rng.rand(h, w) < 0.7  # sparse, as KITTI's lidar ground truth
        write_flow_png(flow, str(gt / "flow_occ" / f"{i:06d}_10.png"))
        flow[:, :, 2] *= rng.rand(h, w) < 0.9  # noc: occluded pixels dropped
        write_flow_png(flow, str(gt / "flow_noc" / f"{i:06d}_10.png"))
        (gt / "obj_map" / f"{i:06d}_10.png").write_bytes(
            imageio.encode_png(rng.randint(0, 3, (h, w)).astype(np.uint8)))
    return {"kitti": kitti, "sintel": sintel, "gt": str(gt), "root": root}


def _same(a, b):
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_same, a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("cache", [False, True], ids=["no_cache", "cache"])
@pytest.mark.parametrize("emit_uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("name", ["KITTI_Prepared", "SINTEL_Prepared"])
def test_prepared_datasets_equal_jax(trees, name, emit_uint8, cache, tmp_path):
    data_dir = trees["kitti" if name == "KITTI_Prepared" else "sintel"]

    def make(pkg, **kw):
        cache_dir = str(tmp_path / pkg.__name__.split(".")[0]) if cache else None
        return getattr(pkg, name)(data_dir, img_hw=IMG_HW, cache_dir=cache_dir,
                                  emit_uint8=emit_uint8, **kw)

    got, want = make(port_datasets, num_iterations=N_ITER), make(jax_datasets,
                                                                 num_iterations=N_ITER)
    assert len(got) == len(want) == N_ITER
    for _ in range(2 if cache else 1):  # a cache is filled, then read
        for i in range(N_ITER):
            assert _same(got[i], want[i]), i
    unflipped = [got._resized_uint8(got.rand_num(i)[0]) for i in range(N_ITER)]
    if not emit_uint8:
        unflipped = [np.asarray(u, np.float32) / 255.0 for u in unflipped]
    flips = sum(not np.array_equal(got[i], u) for i, u in enumerate(unflipped))
    assert 0 < flips < N_ITER  # both branches of the joint flip were taken

    # without num_iterations: index order, the flip drawn from np.random
    got, want = make(port_datasets), make(jax_datasets)
    for i in range(N_SNIPPETS):
        np.random.seed(i)
        a = got[i]
        np.random.seed(i)
        assert _same(a, want[i]), i
    if name == "KITTI_Prepared":
        got, want = (make(pkg, return_intrinsics=True) for pkg in (port_datasets, jax_datasets))
        for i in range(N_SNIPPETS):
            assert _same(got[i], want[i]), i


@pytest.mark.parametrize("name", ["KITTI_2012", "KITTI_2015"])
def test_eval_pairs_equal_jax(trees, name):
    got = getattr(port_datasets, name)(trees["gt"], img_hw=EVAL_HW)
    want = getattr(jax_datasets, name)(trees["gt"], img_hw=EVAL_HW)
    assert len(got) == len(want)
    for i in (0, 1, 77, len(want) - 1):
        assert _same(got[i], want[i]), i
        assert got[i].shape == (2 * EVAL_HW[0], EVAL_HW[1], 3)


@pytest.mark.parametrize("mode", ["kitti_2012", "kitti_2015"])
def test_ground_truth_flow_equals_jax(trees, mode):
    got_flows, got_noc = load_gt_flow_kitti(trees["gt"], mode)
    want_flows, want_noc = jax_gt_flow(trees["gt"], mode)
    assert len(got_flows) == len(want_flows) == {"kitti_2012": 194, "kitti_2015": 200}[mode]
    assert all(map(_same, got_flows, want_flows)) and all(map(_same, got_noc, want_noc))
    assert 0 < got_noc[0].mean() < got_flows[0][:, :, 2].mean() < 1


def test_ground_truth_masks_equal_jax(trees):
    got, want = load_gt_mask(trees["gt"]), jax_gt_mask(trees["gt"])
    assert len(got) == len(want) == N_GT
    assert all(map(_same, got, want))
    assert set(np.unique(got[0])) == {0, 1}


@pytest.mark.parametrize("drop_last", [False, True], ids=["keep_last", "drop_last"])
def test_batch_loader_equals_jax(trees, drop_last):
    def make(pkg):
        return pkg.KITTI_Prepared(trees["kitti"], img_hw=IMG_HW, num_iterations=N_ITER,
                                  emit_uint8=True)

    got = list(BatchLoader(make(port_datasets), 5, num_workers=2, prefetch_batches=1,
                           drop_last=drop_last))
    want = list(JaxBatchLoader(make(jax_datasets), 5, num_workers=2, drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    assert all(_same(a, b) for a, b in zip(got, want))


def test_background_keeps_order_forwards_errors_and_stops():
    assert list(background(iter(range(50)), depth=2)) == list(range(50))

    def failing():
        yield 1
        raise KeyError("drawn")

    it = background(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="drawn"):
        next(it)

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = background(endless(), depth=1)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the consumer stops early: the producer closes its source
    assert closed.wait(5)
