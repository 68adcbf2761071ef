"""The port's tensor-bundle reader (deepvision_tpu_torch/utils/
tf_checkpoint.py) against `tf.train.load_checkpoint`.

Key for key (`get_variable_to_shape_map`) and array for array (dtype,
shape and values, exact) on:
- a `tf.train.Checkpoint` of Keras models and a counter, as the
  reference's GAN trainers save them;
- a `tf.raw_ops.SaveV2` file with TF 2.1 keys (`layer_with_weights-N`),
  every dtype the reader decodes, and 7000 keys: several data blocks in
  the index table;
- chip_smoke.py's own writer (the card's machine has no TensorFlow),
  read back by TensorFlow.
`crc32c_np` (numpy lanes) equals `crc32c_py` (the byte loop) at lengths
around its switch from one to the other. `latest_checkpoint` on a
directory is TensorFlow's; a flipped data byte
fails its tensor's CRC32C and a flipped index byte its block's; a
partitioned variable, a string tensor and a snappy-compressed block are
refused by name."""

import os
import struct
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from deepvision_tpu_torch.data.records import (crc32c_py,  # noqa: E402
                                               masked_crc)
from deepvision_tpu_torch.utils import tf_checkpoint  # noqa: E402

torch.set_num_threads(1)


def assert_same_as_tf(path):
    want = tf.train.load_checkpoint(path)
    got = tf_checkpoint.load_checkpoint(path)
    shapes = want.get_variable_to_shape_map()
    assert got.get_variable_to_shape_map() == shapes
    dtypes = want.get_variable_to_dtype_map()
    assert got.get_variable_to_dtype_map() == {
        k: f"DT_{v.name.upper()}".replace("DT_FLOAT32", "DT_FLOAT")
        .replace("DT_FLOAT64", "DT_DOUBLE").replace("DT_FLOAT16", "DT_HALF")
        for k, v in dtypes.items()}
    read = 0
    for name in shapes:
        if dtypes[name] == tf.string:
            continue
        w, g = np.asarray(want.get_tensor(name)), got.get_tensor(name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        read += 1
    return read


def test_keras_models_checkpoint_equals_tf(tmp_path):
    L = tf.keras.layers
    gen = tf.keras.Sequential([
        L.Input((16,)), L.Dense(4 * 4 * 8, use_bias=False),
        L.BatchNormalization(), L.Reshape((4, 4, 8)),
        L.Conv2DTranspose(4, 3, strides=2, padding="same", use_bias=False)])
    disc = tf.keras.Sequential([L.Input((8, 8, 4)), L.Conv2D(2, 3),
                                L.Flatten(), L.Dense(1)])
    ckpt = tf.train.Checkpoint(generator=gen, discriminator=disc,
                               epoch=tf.Variable(3, dtype=tf.int64))
    path = ckpt.save(str(tmp_path / "ck"))
    assert assert_same_as_tf(path) == 12     # 10 weights, epoch, save_counter
    got = tf_checkpoint.load_checkpoint(path)
    assert got.has_tensor("epoch/.ATTRIBUTES/VARIABLE_VALUE")
    assert int(got.get_tensor("epoch/.ATTRIBUTES/VARIABLE_VALUE")) == 3
    assert tf_checkpoint.OBJECT_GRAPH in got.get_variable_to_shape_map()


DTYPES = (np.float32, np.float64, np.float16, np.int32, np.int64, np.bool_)


def _save_v2(prefix, n):
    rs = np.random.RandomState(0)
    names, tensors, arrays = [], [], {}
    for i in range(n):
        dtype = DTYPES[i % len(DTYPES)]
        name = (f"discriminator_a/layer_with_weights-{i}/"
                f"{('kernel', 'gamma', 'moving_mean')[i % 3]}"
                f"/.ATTRIBUTES/VARIABLE_VALUE")
        arrays[name] = np.asarray(rs.randn(*((i % 3,) * (i % 4))) * 10
                                  ).astype(dtype)
        names.append(name)
        tensors.append(tf.constant(arrays[name]))
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * n, tensors=tensors)
    return arrays


def _data_blocks(prefix):
    table = tf_checkpoint._Table(prefix + ".index", crc32c_py)
    return len(list(tf_checkpoint._block_entries(
        table.block(*table.index, "index"), "index")))


def test_save_v2_with_every_dtype_and_several_blocks_equals_tf(tmp_path):
    prefix = str(tmp_path / "many")
    arrays = _save_v2(prefix, 7000)
    assert _data_blocks(prefix) >= 2
    assert assert_same_as_tf(prefix) == 7000
    got = tf_checkpoint.CheckpointReader(prefix)
    for name, array in list(arrays.items())[:60]:
        np.testing.assert_array_equal(got.get_tensor(name), array)


def test_latest_checkpoint_on_a_directory(tmp_path):
    v = tf.Variable(np.arange(3.0, dtype=np.float32))
    manager = tf.train.CheckpointManager(tf.train.Checkpoint(v=v),
                                         str(tmp_path / "dir"), 3)
    for _ in range(2):
        manager.save()
    directory = str(tmp_path / "dir")
    assert tf_checkpoint.latest_checkpoint(directory) == \
        tf.train.latest_checkpoint(directory)
    assert tf_checkpoint.load_checkpoint(directory).prefix.endswith("ckpt-2")
    assert assert_same_as_tf(directory) == 2
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert tf_checkpoint.latest_checkpoint(empty) is None
    with pytest.raises(FileNotFoundError,
                       match=f"no tf.train checkpoint under {empty}"):
        tf_checkpoint.load_checkpoint(empty)


def _flip(path, at):
    with open(path, "r+b") as fp:
        fp.seek(at)
        byte = fp.read(1)
        fp.seek(at)
        fp.write(bytes([byte[0] ^ 0x01]))


def test_a_flipped_data_byte_fails_the_tensor_crc(tmp_path):
    prefix = str(tmp_path / "ck")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=["a", "b"],
                      shape_and_slices=["", ""],
                      tensors=[tf.constant(np.arange(8.0)),
                               tf.constant(np.ones(4, np.float32))])
    reader = tf_checkpoint.CheckpointReader(prefix)
    _flip(reader.shard_path(0), reader.entries["a"].offset + 3)
    with pytest.raises(tf_checkpoint.CheckpointFormatError,
                       match="bad CRC32C of a"):
        reader.get_tensor("a")
    np.testing.assert_array_equal(reader.get_tensor("b"), np.ones(4))


def test_a_flipped_index_byte_fails_its_block_crc(tmp_path):
    prefix = str(tmp_path / "ck")
    _save_v2(prefix, 20)
    _flip(prefix + ".index", 5)
    with pytest.raises(tf_checkpoint.CheckpointFormatError,
                       match="bad block CRC32C"):
        tf_checkpoint.CheckpointReader(prefix)


def test_partitioned_and_string_tensors_are_refused_by_name(tmp_path):
    prefix = str(tmp_path / "ck")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=["v", "s"],
                      shape_and_slices=["4 0,2", ""],
                      tensors=[tf.constant([1.0, 2.0]),
                               tf.constant(b"graph")])
    reader = tf_checkpoint.CheckpointReader(prefix)
    assert reader.get_variable_to_shape_map() == \
        tf.train.load_checkpoint(prefix).get_variable_to_shape_map()
    with pytest.raises(NotImplementedError, match="v: a partitioned"):
        reader.get_tensor("v")
    with pytest.raises(NotImplementedError, match="s: DT_STRING"):
        reader.get_tensor("s")


def test_a_snappy_block_is_refused_by_name(tmp_path):
    prefix = str(tmp_path / "ck")
    _save_v2(prefix, 4)
    table = tf_checkpoint._Table(prefix + ".index", crc32c_py)
    offset, size = table.index
    data = bytearray(table.data)
    data[offset + size] = 1                        # the type: snappy
    struct.pack_into("<I", data, offset + size + 1, masked_crc(crc32c_py(
        bytes(data[offset:offset + size + 1]))))
    with open(prefix + ".index", "wb") as fp:
        fp.write(bytes(data))
    with pytest.raises(NotImplementedError, match="snappy-compressed"):
        tf_checkpoint.CheckpointReader(prefix)


@pytest.mark.parametrize("n", [0, 1, 100, 16 * 65536 - 1, 16 * 65536,
                               16 * 65536 + 7, 3_000_001])
def test_crc32c_in_numpy_lanes_equals_the_byte_loop(n):
    data = np.random.RandomState(n % 97).bytes(n)
    for crc in (0, 0x1234ABCD):
        assert tf_checkpoint.crc32c_np(data, crc) == crc32c_py(data, crc)


def test_chip_smoke_writer_read_back_by_tf(tmp_path):
    rs = np.random.RandomState(3)
    tensors = {f"generator/layer_with_weights-{i}/kernel/.ATTRIBUTES/"
               f"VARIABLE_VALUE": rs.randn(3, i % 5 + 1).astype(np.float32)
               for i in range(300)}
    tensors.update({
        "epoch/.ATTRIBUTES/VARIABLE_VALUE": np.array(7, np.int64),
        "x/bool": np.array([True, False]), "x/half": np.arange(
            3, dtype=np.float16), "x/double": np.arange(3.0),
        "x/int": np.arange(3, dtype=np.int32), "x/empty": np.zeros(
            (0, 2), np.float32)})
    directory = tmp_path / "ref"
    directory.mkdir()
    prefix = chip_smoke.write_tf_checkpoint(str(directory / "ckpt-1"),
                                            tensors, crc32c_py)
    assert tf.train.latest_checkpoint(str(directory)) == prefix
    reader = tf.train.load_checkpoint(prefix)
    assert set(reader.get_variable_to_shape_map()) == set(tensors)
    for name, array in tensors.items():
        got = np.asarray(reader.get_tensor(name))
        assert got.dtype == array.dtype and got.shape == array.shape, name
        np.testing.assert_array_equal(got, array, err_msg=name)
    assert _data_blocks(prefix) >= 2
    assert assert_same_as_tf(str(directory)) == len(tensors)
