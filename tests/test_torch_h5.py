"""The port's HDF5 reader (deepvision_tpu_torch/utils/h5.py) against h5py.

For every file below, `visit_datasets` yields what h5py's `visititems`
visits, dataset for dataset and in the same order: the same names, and
arrays of the same dtype, shape and bytes (exact: the reader copies the
stored bytes). The files:
- both legacy Keras layouts the JAX package's tests write: the YOLO h5
  (tests/test_keras_convert.py::write_legacy_h5, nested groups of the
  reference's layer names) and the auto-named one with its `layer_names`
  and `weight_names` attributes (tests/test_order_convert.py);
- a group of 300 members and 40 attributes: a B-tree of two levels and a
  continued object header;
- hypothesis-drawn trees of groups and f16/f32/f64/int datasets,
  contiguous, compact and of zero size, and never-written ones;
- hard and soft links;
- chip_smoke.py's own writer (the card's machine has no h5py), read back
  by h5py.
What the reader does not know it refuses by name: gzip-compressed and
chunked data, `libver="latest"`, `track_order=True`, big-endian data."""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

h5py = pytest.importorskip("h5py")
tf = pytest.importorskip("tensorflow")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from deepvision_tpu_torch.utils import h5  # noqa: E402
from test_keras_convert import (build_seeded_keras_yolo,  # noqa: E402
                                write_legacy_h5)
from test_order_convert import _write_legacy_h5  # noqa: E402

torch.set_num_threads(1)


def h5py_datasets(path):
    out = []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out.append((name, np.asarray(obj[()])))

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def assert_same_as_h5py(path):
    want = h5py_datasets(path)
    got = list(h5.visit_datasets(path))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    return got


def test_yolo_legacy_h5_equals_h5py(tmp_path):
    path = str(tmp_path / "yolo.h5")
    write_legacy_h5(build_seeded_keras_yolo(), path)
    got = assert_same_as_h5py(path)
    assert len(got) > 100


def _auto_named_keras_model():
    L = tf.keras.layers
    x = inputs = L.Input((8, 8, 3))
    x = L.Conv2D(4, 3, padding="same")(x)
    x = L.BatchNormalization()(x)
    x = L.Conv2DTranspose(2, 3, strides=2, padding="same", use_bias=False)(x)
    x = L.Flatten()(x)
    x = L.Dense(5)(x)
    model = tf.keras.Model(inputs, x)
    rs = np.random.RandomState(0)
    for w in model.weights:
        w.assign(rs.randn(*w.shape).astype(np.float32))
    return model


def test_auto_named_legacy_h5_with_attributes_equals_h5py(tmp_path):
    path = str(tmp_path / "auto.h5")
    _write_legacy_h5(_auto_named_keras_model(), path)
    with h5py.File(path, "r") as f:
        assert "layer_names" in f.attrs
    assert len(assert_same_as_h5py(path)) == 9


def _root_layout(path):
    """(levels of the root group's B-tree, continuation messages of its
    header) as the reader sees them."""
    with open(path, "rb") as fp:
        f = h5._File(fp, path)
        header = h5._Header(f, f.root[1], "/")
        stab = header.find(h5.SYMBOL_TABLE)[1]
        level = f.read(f.offset(stab, 0), 8)[5]
        continued = [t for t, _, _ in header.messages].count(
            h5.CONTINUATION)
    return level, continued


def test_a_large_group_two_btree_levels_and_a_continued_header(tmp_path):
    path = str(tmp_path / "large.h5")
    rs = np.random.RandomState(1)
    with h5py.File(path, "w") as f:
        for i in range(300):
            f.create_dataset(f"layer_{rs.randint(10 ** 6)}_{i}",
                             data=rs.randn(3).astype(np.float32))
        for i in range(40):
            f.attrs[f"attribute_{i}"] = np.arange(100)
    level, continued = _root_layout(path)
    assert level >= 1 and continued >= 1
    assert len(assert_same_as_h5py(path)) == 300


def test_links_are_visited_as_h5py_visits_them(tmp_path):
    """A hard link to a visited dataset is not visited again; soft links,
    dangling or not, are not followed."""
    path = str(tmp_path / "links.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("a/x", data=np.arange(3.0))
        f["b"] = h5py.SoftLink("/a/x")
        f["c"] = h5py.SoftLink("/missing")
        f["d"] = f["a/x"]
    assert [n for n, _ in assert_same_as_h5py(path)] == ["a/x"]


_NAMES = st.text(alphabet="abcXY_:0123456789", min_size=1, max_size=6)
_DTYPES = st.sampled_from([np.float16, np.float32, np.float64, np.int8,
                           np.uint8, np.int16, np.int32, np.int64,
                           np.uint32])
_DATASETS = st.tuples(
    _DTYPES, st.lists(st.integers(0, 4), min_size=0, max_size=3),
    st.sampled_from(["contiguous", "compact", "unwritten"]),
    st.integers(0, 2 ** 31 - 1))
_TREES = st.recursive(
    _DATASETS, lambda kids: st.dictionaries(_NAMES, kids, max_size=5),
    max_leaves=12)


def _write_tree(group, tree):
    for name, node in tree.items():
        if isinstance(node, dict):
            _write_tree(group.create_group(name), node)
            continue
        dtype, shape, layout, seed = node
        data = np.asarray(np.random.RandomState(seed).uniform(
            -100, 100, shape)).astype(dtype)
        if layout == "unwritten":
            group.create_dataset(name, shape=tuple(shape), dtype=dtype)
        elif layout == "compact" and data.nbytes:
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            space = h5py.h5s.create_simple(data.shape) if data.ndim \
                else h5py.h5s.create(h5py.h5s.SCALAR)
            dset = h5py.h5d.create(group.id, name.encode(),
                                   h5py.h5t.py_create(data.dtype), space,
                                   dcpl=dcpl)
            dset.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        else:
            group.create_dataset(name, data=data)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=st.dictionaries(_NAMES, _TREES, min_size=1, max_size=6))
def test_drawn_trees_equal_h5py(tmp_path, tree):
    path = str(tmp_path / "drawn.h5")
    with h5py.File(path, "w") as f:
        _write_tree(f, tree)
    assert_same_as_h5py(path)


def _gzip(f):
    f.create_dataset("x", data=np.arange(300.0), compression="gzip")


def _chunked(f):
    f.create_dataset("x", data=np.arange(300.0), chunks=(10,))


def _big_endian(f):
    f.create_dataset("x", data=np.arange(3.0).astype(">f4"))


@pytest.mark.parametrize("write,kwargs,match", [
    (_gzip, {}, "x: filter pipeline"),
    (_chunked, {}, "x: chunked storage"),
    (_big_endian, {}, "x: big-endian"),
    (_big_endian, {"libver": "latest"}, "superblock version 3"),
    (lambda f: f.create_group("g").create_dataset("x", data=[1.0]),
     {"track_order": True}, r"version 2 object header .*track_order"),
], ids=["gzip", "chunked", "big_endian", "libver_latest", "track_order"])
def test_unknown_features_are_refused_by_name(tmp_path, write, kwargs,
                                             match):
    path = str(tmp_path / "refused.h5")
    with h5py.File(path, "w", **kwargs) as f:
        write(f)
    with pytest.raises(NotImplementedError, match=match):
        list(h5.visit_datasets(path))


def test_chip_smoke_writer_read_back_by_h5py(tmp_path):
    rs = np.random.RandomState(2)
    tree = {"darknet_53": {"conv2d_0_conv2d": {
        "kernel:0": rs.randn(3, 3, 3, 8).astype(np.float32)}},
        "mixed": {"h": np.arange(4, dtype=np.float16),
                  "d": np.float64(2.5), "i": np.arange(5, dtype=np.int64),
                  "u": np.arange(3, dtype=np.uint8),
                  "e": np.zeros((0, 4), np.float32)},
        "empty": {}}
    for i in range(700):        # 88 symbol nodes: a two-level B-tree
        tree[f"conv2d_{i}"] = {f"conv2d_{i}": {
            "kernel:0": rs.randn(2).astype(np.float32)}}
    path = str(tmp_path / "writer.h5")
    chip_smoke.write_h5(path, tree)

    def flat(node, prefix=""):
        for name, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}{name}/")
            else:
                yield f"{prefix}{name}", np.asarray(value)

    written = dict(flat(tree))
    with h5py.File(path, "r") as f:
        assert list(f["empty"]) == []
        for name, value in written.items():   # lookups walk the B-tree
            got = np.asarray(f[name][()])
            assert got.dtype == value.dtype and got.shape == value.shape
            assert got.tobytes() == value.tobytes(), name
    got = assert_same_as_h5py(path)
    assert sorted(n for n, _ in got) == sorted(written)
    assert _root_layout(path)[0] == 1


def test_a_file_that_is_not_hdf5_is_refused(tmp_path):
    path = tmp_path / "not.h5"
    path.write_bytes(b"\0" * 2048)
    with pytest.raises(h5.H5FormatError, match="no HDF5 signature"):
        list(h5.visit_datasets(str(path)))
