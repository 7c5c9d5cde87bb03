"""``unopticalflow_tpu_torch/utils/hdf5.py`` against h5py, on files h5py
writes (CPU; h5py and scipy are here): user blocks, the three layouts, the
filters, byte orders, large groups, object-header continuations, reference
arrays and first-axis reads; the structures outside the reader's subset
raise with their names.  Then the two callers without h5py
(``sys.modules["h5py"] = None``): ``NYU_Prepare``'s ``train.txt`` and
``load_nyu_test_data``'s arrays equal the JAX package's."""

import os
import sys

import h5py
import numpy as np
import pytest
import scipy.io

from unopticalflow_tpu_torch.utils import hdf5

DTYPES = ("<u1", "<u2", ">u2", "<i4", ">i4", "<f4", ">f4", "<f8", ">f8")
LAYOUTS = ("compact", "contiguous", "gzip", "shuffle_gzip_fletcher32")


def _write(f, name, data, layout):
    if layout == "compact":
        tid = h5py.h5t.py_create(data.dtype)
        space = h5py.h5s.create_simple(data.shape)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dsid = h5py.h5d.create(f.id, name.encode(), tid, space, dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
    elif layout == "contiguous":
        f.create_dataset(name, data=data)
    elif layout == "gzip":
        f.create_dataset(name, data=data, chunks=(2,) + data.shape[1:2] + (3,) * (data.ndim - 2),
                         compression="gzip", compression_opts=4)
    else:  # ragged edge chunks: 3 does not divide 7 or 10
        f.create_dataset(name, data=data, chunks=(3,) * data.ndim, compression="gzip",
                         shuffle=True, fletcher32=True)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("userblock", [0, 512, 1024])
def test_datasets_equal_h5py(tmp_path, userblock, layout):
    rng = np.random.RandomState(userblock + len(layout))
    path = tmp_path / "a.h5"
    arrays = {}
    with h5py.File(path, "w", userblock_size=userblock or None) as f:
        for k, dt in enumerate(DTYPES):
            shape = (7, 10) if k % 2 else (5, 4, 10)
            if layout == "compact":
                shape = (3, 5)  # a compact dataset lives in its 64 KB header
            if np.dtype(dt).kind == "f":
                a = (rng.randn(*shape) * 100).astype(dt)
            else:
                info = np.iinfo(dt)
                a = rng.randint(info.min, int(info.max) + 1, shape, dtype=np.int64).astype(dt)
            arrays[f"d{k}"] = a
            _write(f, f"d{k}", a, layout)
    if userblock:
        with open(path, "r+b") as fh:  # MATLAB writes its own text into the block
            fh.write(b"MATLAB 7.3 MAT-file".ljust(userblock, b" ")[:userblock])
    with h5py.File(path, "r") as ref, hdf5.File(str(path)) as f:
        assert sorted(f.keys()) == sorted(ref.keys())
        for name, a in arrays.items():
            ds = f[name]
            assert ds.shape == ref[name].shape == a.shape
            assert ds.dtype == ref[name].dtype
            got = np.asarray(ds)
            assert got.dtype == ref[name][()].dtype
            np.testing.assert_array_equal(got, ref[name][()])
            np.testing.assert_array_equal(ds[1], ref[name][1])
            np.testing.assert_array_equal(ds[-1], ref[name][-1])
            np.testing.assert_array_equal(ds[[0, 2]], ref[name][[0, 2]])
            np.testing.assert_array_equal(ds[1:3, 1:], ref[name][1:3, 1:])


def test_first_axis_reads_touch_only_their_chunks(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (12, 3, 16, 8)).astype(np.uint8)
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=a, chunks=(1, 3, 16, 8), compression="gzip")
    decoded = []
    real = hdf5.Dataset._decode_chunk

    def counting(self, raw, mask):
        decoded.append(1)
        return real(self, raw, mask)

    monkeypatch.setattr(hdf5.Dataset, "_decode_chunk", counting)
    with hdf5.File(str(path)) as f:
        idx = np.array([9, 2, 5, 2])  # unsorted, repeated, as a split's indices may be
        with h5py.File(path, "r") as ref:
            want = ref["images"][np.unique(idx)][np.unique(idx, return_inverse=True)[1]]
        np.testing.assert_array_equal(f["images"][idx], want)
        assert len(decoded) == 3
        np.testing.assert_array_equal(f["images"][4], a[4])
        assert len(decoded) == 4


def test_large_groups_continuations_and_references(tmp_path):
    rng = np.random.RandomState(1)
    path = tmp_path / "g.h5"
    with h5py.File(path, "w") as f:
        grp = f.create_group("#refs#")
        refs = []
        for k in range(300):  # 300 members: many symbol table nodes, a B-tree of two levels
            name = "".join(chr(97 + (k * 7 + j) % 26) for j in range(1 + k % 9))
            ds = grp.create_dataset(f"r{k:03d}", data=np.array([ord(c) for c in name],
                                                               np.uint16)[:, None])
            refs.append(ds.ref)
        scenes = f.create_dataset("scenes", (1, len(refs)), dtype=h5py.ref_dtype)
        scenes[0, :] = refs
        many = f.create_dataset("many_attrs", data=np.arange(6.0))
        for k in range(80):  # attributes overflow the first header block
            many.attrs[f"attribute_{k:02d}"] = np.full(k % 5 + 1, k, np.int32)
        many.attrs["MATLAB_class"] = np.bytes_(b"double")
        f.create_dataset("late", data=rng.randn(4, 3).astype(np.float32))
    with h5py.File(path, "r") as ref, hdf5.File(str(path)) as f:
        assert sorted(f["#refs#"].keys()) == sorted(ref["#refs#"].keys())
        assert len(f["#refs#"].keys()) == 300
        got_refs = f["scenes"][0]
        want_refs = ref["scenes"][0]
        assert got_refs.shape == want_refs.shape == (300,)
        for g, w in zip(got_refs, want_refs):
            np.testing.assert_array_equal(f[g][:], ref[w][:])
            assert f[g].name and f[g][:].dtype == np.uint16
        split = np.array([5, 1, 299])
        for g, w in zip(f["scenes"][0][split], ref["scenes"][0][split]):
            assert "".join(chr(j) for j in f[g][:].ravel()) == \
                "".join(chr(j) for j in ref[w][:].ravel())
        np.testing.assert_array_equal(f["many_attrs"][:], ref["many_attrs"][:])
        np.testing.assert_array_equal(f["late"][:], ref["late"][:])
        np.testing.assert_array_equal(f["#refs#/r017"][:], ref["#refs#/r017"][:])
        with pytest.raises(KeyError, match="nothing"):
            f["nothing"]


def test_what_lies_outside_the_subset_raises(tmp_path):
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4), chunks=(2,), maxshape=(None,))
    with pytest.raises(ValueError, match="superblock version 3"):
        hdf5.File(str(latest))
    # a version-4 layout message (what libver='latest' writes for a chunk index)
    v4 = bytes([4, 2, 1, 2]) + bytes(8) + (2).to_bytes(4, "little") + bytes(8)
    with pytest.raises(ValueError, match="layout message version 4.*chunk index"):
        hdf5.parse_layout(v4, 8, 8)
    other = tmp_path / "other.h5"
    with h5py.File(other, "w") as f:
        f.create_dataset("lzf", data=np.arange(10.0), chunks=(5,), compression="lzf")
        f.create_dataset("text", data=["a", "bc"], dtype=h5py.string_dtype())
        f.create_dataset("fixed", data=np.array([b"ab", b"cd"]))
        f.create_dataset("scalar", data=3.0)
    with hdf5.File(str(other)) as f:
        with pytest.raises(ValueError, match="scalar"):
            f["scalar"]
        with pytest.raises(ValueError, match="filter 32000"):
            f["lzf"]
        with pytest.raises(ValueError, match="variable-length"):
            f["text"][:]
        with pytest.raises(ValueError, match="string"):
            np.asarray(f["fixed"])
    notes = tmp_path / "notes.txt"
    notes.write_text("x" * 4000)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(str(notes))


def _labeled_mat(test_dir, rng, n=4):
    """A MATLAB-layout labeled set: ``images`` (n, 3, 640, 480) uint8 and
    ``depths`` (n, 640, 480) float32, chunked and deflated, and ``scenes``
    (1, n) references to (len, 1) uint16 char datasets under ``#refs#``."""
    os.makedirs(test_dir, exist_ok=True)
    path = os.path.join(test_dir, "nyu_depth_v2_labeled.mat")
    names = ["bedroom_0001", "kitchen_0002", "office_0003", "kitchen_0002"][:n]
    with h5py.File(path, "w", userblock_size=512) as f:
        img = rng.randint(0, 256, (n, 3, 640, 480)).astype(np.uint8)
        f.create_dataset("images", data=img, chunks=(1, 3, 160, 120), compression="gzip")
        dep = (rng.rand(n, 640, 480) * 9 + 0.5).astype(np.float32)
        f.create_dataset("depths", data=dep, chunks=(1, 160, 120), compression="gzip")
        grp = f.create_group("#refs#")
        refs = [grp.create_dataset(f"s{k}", data=np.array([[ord(c)] for c in nm], np.uint16)).ref
                for k, nm in enumerate(names)]
        scenes = f.create_dataset("scenes", (1, n), dtype=h5py.ref_dtype)
        scenes[0, :] = refs
    with open(path, "r+b") as fh:
        fh.write(b"MATLAB 7.3 MAT-file, Platform: GLNXA64".ljust(128, b" "))
    scipy.io.savemat(os.path.join(test_dir, "splits.mat"),
                     {"trainNdxs": np.array([[1], [2]]), "testNdxs": np.array([[4], [3]])})
    return path


def test_load_nyu_test_data_without_h5py_equals_jax(tmp_path, monkeypatch):
    from unopticalflow_tpu.evaluation import depth_harness as jdh
    from unopticalflow_tpu_torch.evaluation import depth_harness

    _labeled_mat(str(tmp_path), np.random.RandomState(3))
    want_images, want_depths = jdh.load_nyu_test_data(str(tmp_path))
    monkeypatch.setitem(sys.modules, "h5py", None)
    images, depths = depth_harness.load_nyu_test_data(str(tmp_path))
    assert images.dtype == want_images.dtype and depths.dtype == want_depths.dtype
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(depths, want_depths)
    assert images.shape == (2, 3, 480, 640) and depths.shape == (2, 480, 640)


def test_nyu_prepare_without_h5py_equals_jax(tmp_path, monkeypatch):
    from unopticalflow_tpu.data import preparers as jprep
    from unopticalflow_tpu_torch.data import preparers
    from tests.test_torch_nyu import _raw_nyu_tree

    raw, test = _raw_nyu_tree(tmp_path)
    ref = jprep.NYU_Prepare(raw, test)
    want_train, want_test = ref.get_train_scenes(), ref.get_test_scenes()
    ref.prepare_data_mp(str(tmp_path / "jax"), stride=10, num_processes=2)
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = preparers.NYU_Prepare(raw, test)
    assert port.get_train_scenes() == want_train
    assert port.get_test_scenes() == want_test
    port.prepare_data_mp(str(tmp_path / "port"), stride=10, num_processes=2)
    assert ((tmp_path / "port" / "train.txt").read_bytes()
            == (tmp_path / "jax" / "train.txt").read_bytes())


def test_nyu_prepare_reads_matlab_char_columns(tmp_path, monkeypatch):
    """MATLAB stores a 1 x L char array as an (L, 1) dataset: the port joins
    its characters as h5py would give them, flattened."""
    from unopticalflow_tpu_torch.data import preparers

    test = tmp_path / "test"
    _labeled_mat(str(test), np.random.RandomState(4))
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = preparers.NYU_Prepare(str(tmp_path / "raw"), str(test))
    assert port.get_train_scenes() == ["bedroom_0001", "kitchen_0002"]
    assert port.get_test_scenes() == ["kitchen_0002", "office_0003"]
