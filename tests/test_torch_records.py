"""The port's TFRecord reader and writer, its `tf.train.Example` codec and
its file lists (deepvision_tpu_torch/data/records.py) against TensorFlow's
own, on the CPU: records exact both ways, every feature kind round trips,
a flipped byte raises naming the file and the offset, a remote path
whose protocol's package is absent is refused by name, and the ranks'
files partition the pattern as JAX's
`files.shard` does."""

import sys

import numpy as np
import pytest
import tensorflow as tf

from deepvision_tpu_torch.data import records

tf.config.set_visible_devices([], "GPU")


def _tf_example(i: int) -> bytes:
    return tf.train.Example(features=tf.train.Features(feature={
        "b": tf.train.Feature(bytes_list=tf.train.BytesList(
            value=[b"x" * i, b"", bytes(range(256))])),
        "f": tf.train.Feature(float_list=tf.train.FloatList(
            value=[1.5, -2.25, float(i), 3.4e38])),
        "i": tf.train.Feature(int64_list=tf.train.Int64List(
            value=[-1, 2 ** 40, i, 300, -(2 ** 63), 2 ** 63 - 1])),
        "empty_i": tf.train.Feature(int64_list=tf.train.Int64List(value=[])),
        "empty_f": tf.train.Feature(float_list=tf.train.FloatList(value=[])),
        "empty_b": tf.train.Feature(bytes_list=tf.train.BytesList(value=[])),
    })).SerializeToString()


def test_reader_reads_what_tensorflow_wrote(tmp_path):
    path = str(tmp_path / "a.tfrecord")
    want = [_tf_example(i) for i in range(5)] + [b"", b"raw bytes"]
    with tf.io.TFRecordWriter(path) as w:
        for r in want:
            w.write(r)
    assert list(records.read_records(path)) == want
    ex = records.parse_example(want[3])
    assert ex["b"] == records.Feature("bytes", [b"xxx", b"",
                                                bytes(range(256))])
    np.testing.assert_array_equal(ex["f"].values, np.array(
        [1.5, -2.25, 3.0, 3.4e38], np.float32))
    np.testing.assert_array_equal(ex["i"].values, [
        -1, 2 ** 40, 3, 300, -(2 ** 63), 2 ** 63 - 1])
    assert ex["i"].values.dtype == np.int64
    for k, kind in (("empty_i", "int64"), ("empty_f", "float"),
                    ("empty_b", "bytes")):
        assert ex[k].kind == kind and len(ex[k].values) == 0


def test_tensorflow_reads_what_the_port_wrote(tmp_path):
    path = str(tmp_path / "b.tfrecord")
    feats = {"enc": records.bytes_feature([b"\x00\xff", b""]),
             "f": records.float_feature([0.5, -1e-30, np.inf]),
             "i": records.int64_feature([0, -5, 7, 2 ** 62]),
             "none": records.int64_feature([])}
    payloads = [records.encode_example(feats), b"", b"z" * 70000]
    assert records.write_records(path, payloads) == 3
    got = [r.numpy() for r in tf.data.TFRecordDataset(path)]
    assert got == payloads
    ex = tf.train.Example.FromString(got[0])
    f = ex.features.feature
    assert list(f["enc"].bytes_list.value) == [b"\x00\xff", b""]
    np.testing.assert_array_equal(f["f"].float_list.value,
                                  np.array([0.5, -1e-30, np.inf], np.float32))
    assert list(f["i"].int64_list.value) == [0, -5, 7, 2 ** 62]
    assert list(f["none"].int64_list.value) == []


@pytest.mark.parametrize("values", [
    {"k": records.bytes_feature(b"one")},
    {"k": records.bytes_feature([b"a", b"", b"c" * 300])},
    {"k": records.float_feature([])},
    {"k": records.float_feature(np.linspace(-3, 3, 257))},
    {"k": records.int64_feature([])},
    {"k": records.int64_feature([2 ** 63 - 1, -(2 ** 63), 0, 127, 128])},
    {"a": records.int64_feature(1), "b": records.float_feature(2.0),
     "c": records.bytes_feature(b"3")},
], ids=["bytes", "bytes_many", "float_empty", "float_many", "int_empty",
        "int_extremes", "mixed"])
def test_example_codec_round_trips(values):
    data = records.encode_example(values)
    back = records.parse_example(data)
    assert set(back) == set(values)
    for k, feat in values.items():
        assert back[k].kind == feat.kind
        if feat.kind == "bytes":
            assert back[k].values == feat.values
        else:
            np.testing.assert_array_equal(back[k].values, feat.values)
            assert back[k].values.dtype == feat.values.dtype
    # and TensorFlow parses the same bytes to the same values
    parsed = tf.train.Example.FromString(data).features.feature
    for k, feat in values.items():
        lst = {"bytes": parsed[k].bytes_list, "float": parsed[k].float_list,
               "int64": parsed[k].int64_list}[feat.kind]
        assert list(lst.value) == list(feat.values)


def test_unpacked_lists_parse():
    """float and int64 lists written one element a field (older writers)
    parse as the packed ones do."""
    def ld(num, payload):
        return records._enc_varint((num << 3) | 2) \
            + records._enc_varint(len(payload)) + payload
    floats = b"".join(b"\x0d" + np.float32(v).tobytes() for v in (1.0, -2.5))
    ints = b"".join(b"\x08" + records._enc_varint(v) for v in (3, 2 ** 35))
    entry_f = ld(1, ld(1, b"f") + ld(2, ld(2, floats)))
    entry_i = ld(1, ld(1, b"i") + ld(2, ld(3, ints)))
    ex = records.parse_example(ld(1, entry_f + entry_i))
    np.testing.assert_array_equal(ex["f"].values, [1.0, -2.5])
    np.testing.assert_array_equal(ex["i"].values, [3, 2 ** 35])
    tf_ex = tf.train.Example.FromString(ld(1, entry_f + entry_i))
    assert list(tf_ex.features.feature["i"].int64_list.value) == [3, 2 ** 35]


@pytest.mark.parametrize("where", ["length", "length_crc", "data",
                                   "data_crc", "truncated"])
def test_a_corrupt_record_raises_with_file_and_offset(tmp_path, where):
    path = str(tmp_path / "c.tfrecord")
    first, second = b"first record", records.encode_example(
        {"k": records.bytes_feature(b"payload" * 10)})
    records.write_records(path, [first, second])
    raw = bytearray(open(path, "rb").read())
    off = 12 + len(first) + 4             # the second record's offset
    pos = {"length": off, "length_crc": off + 9, "data": off + 20,
           "data_crc": len(raw) - 2}.get(where)
    if where == "truncated":
        raw = raw[:-3]
    else:
        raw[pos] ^= 0x10
    open(path, "wb").write(bytes(raw))
    got = []
    with pytest.raises(records.CorruptRecordError) as err:
        for r in records.read_records(path):
            got.append(r)
    assert got == [first]                 # nothing past the bad record
    assert path in str(err.value) and f"byte {off}" in str(err.value)


def test_crc32c_matches_known_values():
    # RFC 3720's CRC32C check value, and TFRecord's masked CRC of an
    # empty record's length
    assert records.crc32c_py(b"123456789") == 0xE3069283
    assert records.crc32c_py(b"") == 0
    length = (0).to_bytes(8, "little")
    framed = records.frame_record(b"")
    assert framed[8:12] == records.masked_crc(
        records.crc32c_py(length)).to_bytes(4, "little")


def test_remote_patterns_are_refused_by_name(tmp_path, monkeypatch):
    """A remote pattern goes through fsspec (tests/test_torch_remote.py);
    one whose protocol's package is absent is refused by name, before any
    host is contacted (both packages made absent here)."""
    from deepvision_tpu_torch.data.fs import RemotePathError
    for package in ("gcsfs", "s3fs"):
        monkeypatch.setitem(sys.modules, package, None)
    for pattern, package in (("gs://bucket/train-*", "gcsfs"),
                             ("s3://bucket/val*", "s3fs")):
        with pytest.raises(RemotePathError,
                           match=f"needs the '{package}' package"):
            records.list_files(pattern, training=False)
    with pytest.raises(FileNotFoundError, match="no files match"):
        records.list_files(str(tmp_path / "train*"), training=False)


def _shards(tmp_path, n=7):
    for i in range(n):
        (tmp_path / f"train-{i:05d}-of-{n:05d}").write_bytes(b"")
    return str(tmp_path / "train-*")


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_eval_partition_equals_jax_files_shard(tmp_path, world):
    """In eval the files are sorted, then every `world`-th from `rank`:
    the partition of `list_files(shuffle=False).shard(world, rank)`."""
    pattern = _shards(tmp_path)
    for rank in range(world):
        want = [f.decode() for f in tf.data.Dataset.list_files(
            pattern, shuffle=False).shard(world, rank).as_numpy_iterator()]
        assert records.list_files(pattern, training=False, world=world,
                                  rank=rank) == want


@pytest.mark.parametrize("world", [2, 3])
def test_training_ranks_get_disjoint_files_that_cover(tmp_path, world):
    pattern = _shards(tmp_path)
    parts = [records.list_files(pattern, training=True, seed=5,
                                world=world, rank=r) for r in range(world)]
    flat = [f for p in parts for f in p]
    assert len(flat) == len(set(flat)) == 7
    assert sorted(flat) == records.list_files(pattern, training=False)
    # seeded: the same seed gives the same shuffle, another seed another
    assert parts[0] == records.list_files(pattern, training=True, seed=5,
                                          world=world, rank=0)
    orders = {tuple(records.list_files(pattern, training=True, seed=s))
              for s in range(6)}
    assert len(orders) > 1


def test_interleave_order_is_tensorflows(tmp_path):
    """`interleave(cycle_length, block_length)` in TensorFlow's
    deterministic order, over files of unequal lengths."""
    lengths = [5, 1, 7, 0, 3, 9, 2]
    paths = []
    for i, n in enumerate(lengths):
        p = str(tmp_path / f"f{i}")
        records.write_records(p, [f"{i}:{j}".encode() for j in range(n)])
        paths.append(p)
    for cycle, block in ((2, 2), (3, 1), (16, 16), (4, 3)):
        want = [r.numpy() for r in tf.data.Dataset.from_tensor_slices(
            paths).interleave(tf.data.TFRecordDataset, cycle_length=cycle,
                              block_length=block)]
        got = list(records.interleave(paths, cycle_length=cycle,
                                      block_length=block,
                                      reader=records.read_records))
        assert got == want, (cycle, block)


def test_shuffle_buffer_is_a_seeded_permutation():
    rng = np.random.default_rng(0)
    out = list(records.shuffle_buffer(range(100), 10, rng))
    assert sorted(out) == list(range(100)) and out != list(range(100))
    # an element enters the buffer of 10 only after 10 fewer outputs
    assert all(out.index(i) >= i - 10 for i in range(100))
    again = list(records.shuffle_buffer(range(100), 10,
                                        np.random.default_rng(0)))
    assert again == out
