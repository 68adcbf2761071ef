"""The port's input pipelines on the CPU against the JAX package's
(deepvision_tpu_torch/data/{util,jpeg,imagenet,imagenet_flat,detection,
pose,gan}.py against deepvision_tpu/data/*.py), on records written by
TensorFlow and the JAX package's converters (tests/torch_records_fixtures.py).

Tolerances:
- the TF-semantics resizes equal `tf.image.resize` within 1e-3 on [0, 255]
  (measured: 1.5e-4 bicubic, 3e-5 bilinear);
- the CPU decode (PIL) equals `decode_jpeg(dct_method="INTEGER_ACCURATE")`
  exactly, and TensorFlow's default decode within DECODE_GAP levels;
- given TensorFlow's decoded pixels, each eval preprocess equals the JAX
  one within 1e-3 in f32 (on the f32 output's own scale) and 1 level in
  uint8 (a rounding tie);
- end to end on the records (PIL's decode against TensorFlow's default
  one), within what the decode gap implies: DECODE_GAP levels through a
  bilinear resize (weights >= 0 summing to 1), DECODE_GAP x BICUBIC_L1
  through the bicubic one (the sum of |weights| in 2-D), plus a level
  for the uint8 rounding; measured beside each bound.
"""

import io
import os

import numpy as np
import pytest
import tensorflow as tf
import torch

import torch_records_fixtures as fx
from deepvision_tpu.data import detection as jdet
from deepvision_tpu.data import gan as jgan
from deepvision_tpu.data import imagenet as jinet
from deepvision_tpu.data import pose as jpose
from deepvision_tpu.data.imagenet_flat import FlatImageNet as JaxFlat
from deepvision_tpu_torch.data import detection as det
from deepvision_tpu_torch.data import gan as gan_data
from deepvision_tpu_torch.data import imagenet as inet
from deepvision_tpu_torch.data import jpeg, pose, records, util
from deepvision_tpu_torch.data.imagenet_flat import FlatImageNet, NotJpegError
from deepvision_tpu_torch.data.transforms import ColorJitter

tf.config.set_visible_devices([], "GPU")
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg")
# PIL/libjpeg ISLOW against TensorFlow's default (fast integer) IDCT:
# up to 7 levels measured on 500x375 q90 JPEGs at 4:4:4 and 4:2:0
DECODE_GAP = 7
# the 2-D bicubic (a = -0.5) kernel's largest sum of |weights|: 1.5625
# (1.25 an axis, at a half-pixel offset)
BICUBIC_L1 = 1.5625
ONE_LEVEL = 1.0 + 1e-6


def _mean_std():
    return np.asarray(jinet.MEAN_RGB), np.asarray(jinet.STDDEV_RGB)


# -- resizes and decode -------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((37, 53), (24, 29)), ((37, 53), (74, 106)), ((61, 17), (96, 96)),
    ((80, 60), (32, 32)), ((33, 90), (47, 13))],
    ids=["down", "up", "odd_up", "down_square", "odd_aspect"])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_tf_resizes_equal_tensorflow(src, dst, mode):
    img = np.random.RandomState(sum(src)).uniform(0, 255, (*src, 3)) \
        .astype(np.float32)
    want = tf.image.resize(img, dst, method=mode).numpy()
    got = util.resize_image(torch.from_numpy(img), dst, mode).numpy()
    assert float(np.abs(got - want).max()) <= 1e-3


@pytest.mark.parametrize("src,dst", [((60, 80), (32, 43)),
                                     ((40, 30), (64, 48)),
                                     ((75, 50), (33, 22))])
def test_antialiased_bilinear_is_pil_and_torch(src, dst):
    """PIL's BILINEAR (the flat loader's resize) as the antialiased
    bilinear: torch's own within f32 rounding, PIL's uint8 output within
    a level (PIL rounds between its two passes)."""
    from PIL import Image
    u8 = np.random.RandomState(3).randint(0, 256, (*src, 3)).astype(np.uint8)
    got = util.resize_image(torch.from_numpy(u8), dst, "bilinear_aa")
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(u8).permute(2, 0, 1)[None].float(), size=dst,
        mode="bilinear", antialias=True, align_corners=False)[0]
    assert float((got - ref.permute(1, 2, 0)).abs().max()) <= 1e-3
    pil = np.asarray(Image.fromarray(u8).resize(dst[::-1], Image.BILINEAR))
    assert np.abs(np.rint(got.numpy()) - pil).max() <= 1


def _fixture_bytes():
    out = {}
    for name in sorted(f[:-4] for f in os.listdir(FIXTURES)
                       if f.endswith(".jpg")):
        with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as fh:
            out[name] = fh.read()
    return out


def test_cpu_decode_is_integer_accurate_and_near_the_default():
    rs = np.random.RandomState(0)
    cases = dict(_fixture_bytes())
    cases["big_444"] = fx.jpeg(fx.natural_image(375, 500, rs), 90, 0)
    cases["big_420"] = fx.jpeg(fx.natural_image(500, 375, rs), 90, 2)
    for name, data in cases.items():
        got = jpeg.decode_cpu(data)
        exact = tf.io.decode_jpeg(data, channels=3,
                                  dct_method="INTEGER_ACCURATE").numpy()
        np.testing.assert_array_equal(got, exact, err_msg=name)
        default = tf.io.decode_jpeg(data, channels=3).numpy()
        assert np.abs(got.astype(int) - default).max() <= DECODE_GAP, name
        assert jpeg.extract_jpeg_shape(data) == tuple(
            tf.io.extract_jpeg_shape(data).numpy()[:2]) + (
                1 if name == "gray" else 3,)
        # the committed goldens are these decodes
        if name in _fixture_bytes():
            np.testing.assert_array_equal(
                np.load(os.path.join(FIXTURES, name + ".pil.npy")), got)
            np.testing.assert_array_equal(
                np.load(os.path.join(FIXTURES, name + ".tf.npy")), default)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.extract_jpeg_shape(b"\x89PNG\r\n")


def test_to_uint8_rounds_half_to_even_and_clips():
    x = torch.tensor([-3.0, 0.5, 1.5, 2.5, 254.5, 255.7, 300.0])
    assert util.to_uint8_pixels(x).tolist() == [0, 0, 2, 2, 254, 255, 255]


# -- eval preprocess given TensorFlow's pixels -------------------------------

def _record_bytes(path):
    return [r.numpy() for r in tf.data.TFRecordDataset(path)]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    out = {"imagenet": str(root / "imagenet")}
    fx.write_imagenet(out["imagenet"], "val", [20, 17, 19], seed=1)
    fx.write_imagenet(out["imagenet"], "train", [9, 8], seed=2,
                      gray_every=5)
    out["voc"] = fx.write_voc(str(root / "voc"))
    out["mpii"] = fx.write_mpii(str(root / "mpii"))
    out["cyclegan"] = fx.write_cyclegan(str(root / "cg"))
    out["flat"] = str(root / "flat")
    out["synsets"] = fx.write_flat(out["flat"], n=10)
    return out


@pytest.mark.parametrize("mode", ["float", "uint8", "decode_only"])
def test_imagenet_eval_preprocess_equals_jax(data_root, mode):
    mean, std = _mean_std()
    size = 32
    for serialized in _record_bytes(os.path.join(
            data_root["imagenet"], "val-00001-of-00003"))[:6]:
        enc, label = inet.parse_example(serialized)
        jenc, jlabel = jinet.parse_example(serialized, tf)
        assert label == int(jlabel)
        pixels = torch.from_numpy(tf.io.decode_jpeg(enc, channels=3).numpy())
        shape = jpeg.extract_jpeg_shape(enc)[:2]
        kw = dict(normalize_on_host=mode == "float",
                  host_decode_only=mode == "decode_only")
        # under host_decode_only the size given is already the decode size
        decode_size = (inet.decode_image_size(size) if mode == "decode_only"
                       else size)
        want = jinet.preprocess(jenc, jlabel, decode_size, False, tf,
                                mean=mean, std=std, **kw)[0].numpy()
        plan = inet.plan(shape, decode_size, False, None,
                         host_decode_only=mode == "decode_only")
        how = (util.normalized(mean, std) if mode == "float" else util.UINT8)
        got = util.resample([pixels], [plan], (decode_size,) * 2,
                            "bicubic", how)[0].numpy()
        err = float(np.abs(got.astype(np.float32)
                           - want.astype(np.float32)).max())
        assert err <= (1e-3 if mode == "float" else ONE_LEVEL), err


def test_detection_eval_preprocess_equals_jax(data_root):
    size = 48
    path = os.path.join(data_root["voc"], "val_0001_of_0001.tfrecords")
    for serialized in _record_bytes(path):
        ex = det.parse_example(serialized)
        for normalize in (True, False):
            want = jdet.preprocess(serialized, size, False, tf,
                                   with_difficult=True,
                                   normalize_on_host=normalize)
            want = [t.numpy() for t in want]
            pixels = torch.from_numpy(
                tf.io.decode_jpeg(ex.encoded, channels=3).numpy())
            plan, boxes = det.plan(ex, size, False, None)
            got = util.resample([pixels], [plan], (size, size), "bilinear",
                                util.unit_range() if normalize
                                else util.UINT8)[0].numpy()
            err = np.abs(got.astype(np.float32)
                         - want[0].astype(np.float32)).max()
            assert err <= (1e-3 if normalize else ONE_LEVEL)
            for a, b in zip(det.pad_targets(boxes, ex.classes, ex.difficult),
                            [want[1], want[2], want[3], want[4]]):
                np.testing.assert_allclose(a, b, atol=1e-6)


def test_pose_eval_preprocess_equals_jax(data_root):
    size = 40
    path = os.path.join(data_root["mpii"], "val_0001_of_0001.tfrecords")
    for serialized in _record_bytes(path):
        ex = pose.parse_example(serialized)
        for normalize in (True, False):
            want = [t.numpy() for t in jpose.preprocess(
                serialized, size, False, tf, normalize_on_host=normalize)]
            pixels = torch.from_numpy(
                tf.io.decode_jpeg(ex.encoded, channels=3).numpy())
            plan, joints = pose.plan(ex, size, False, None)
            got = util.resample([pixels], [plan], (size, size), "bilinear",
                                util.unit_range() if normalize
                                else util.UINT8)[0].numpy()
            err = np.abs(got.astype(np.float32)
                         - want[0].astype(np.float32)).max()
            assert err <= (1e-3 if normalize else ONE_LEVEL)
            for a, b in zip(joints, want[1:]):
                np.testing.assert_allclose(a, b, atol=1e-6)


def test_cyclegan_eval_preprocess_equals_jax(data_root):
    size = 32
    path = os.path.join(data_root["cyclegan"], "toy", "trainA.tfrecord")
    for serialized in _record_bytes(path):
        want = jgan._parse_cyclegan(serialized, size, False, tf).numpy()
        (enc,) = records.parse_example(serialized)["image/encoded"].values
        pixels = torch.from_numpy(tf.io.decode_jpeg(enc, channels=3).numpy())
        plan = gan_data.cyclegan_plan(tuple(pixels.shape[:2]), size, False,
                                      None)
        got = util.resample([pixels], [plan], (size, size), "bilinear",
                            util.unit_range())[0].numpy()
        assert float(np.abs(got - want).max()) <= 1e-3


# -- end to end on the records ------------------------------------------------

def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("mode", ["float", "uint8"])
def test_imagenet_eval_batches_are_jaxs_in_order(data_root, mode):
    """Three shards through the interleave: the same records in the same
    batches as JAX's pipeline, the pixels within the decode gap (bicubic:
    DECODE_GAP x BICUBIC_L1 levels; measured 4-5)."""
    pattern = os.path.join(data_root["imagenet"], "val*")
    kw = dict(batch_size=4, image_size=32, training=False,
              normalize_on_host=mode == "float")
    want = list(jinet.build_dataset(pattern, **kw).as_numpy_iterator())
    got = list(inet.build_dataset(pattern, **kw).batches(0))
    assert len(got) == len(want) == (20 + 17 + 19) // 4
    levels = DECODE_GAP * BICUBIC_L1
    bound = (levels / 255 / min(jinet.STDDEV_RGB) if mode == "float"
             else levels + 1)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl.numpy(), wl)
        assert gi.dtype == (torch.float32 if mode == "float" else torch.uint8)
        assert _gap(gi, wi) <= bound


def test_imagenet_shards_partition_the_eval_set(data_root):
    pattern = os.path.join(data_root["imagenet"], "val*")
    labels = []
    for rank in range(3):
        ds = inet.build_dataset(pattern, batch_size=1, image_size=16,
                                training=False, num_process=3,
                                process_index=rank)
        jds = jinet.build_dataset(pattern, batch_size=1, image_size=16,
                                  training=False, num_process=3,
                                  process_index=rank)
        got = [int(lab) for _, ls in ds.batches(0) for lab in ls]
        assert got == [int(lab) for _, ls in jds.as_numpy_iterator()
                       for lab in ls]
        labels += got
    assert sorted(labels) == list(range(20 + 17 + 19))


def test_detection_and_pose_records_end_to_end(data_root):
    """One shard each (JAX reads with num_parallel_reads): the same
    records and targets, the pixels within DECODE_GAP levels (bilinear)."""
    kw = dict(batch_size=2, image_size=40, training=False)
    pattern = os.path.join(data_root["voc"], "val*")
    want = list(jdet.build_dataset(pattern, with_difficult=True,
                                   drop_remainder=False,
                                   **kw).as_numpy_iterator())
    got = list(det.build_dataset(pattern, with_difficult=True,
                                 drop_remainder=False, **kw).batches(0))
    assert [len(b[0]) for b in got] == [len(b[0]) for b in want] == [2, 2, 1]
    for g, w in zip(got, want):
        assert _gap(g[0], w[0]) <= DECODE_GAP / 127.5
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    pattern = os.path.join(data_root["mpii"], "val*")
    want = list(jpose.build_dataset(pattern, **kw).as_numpy_iterator())
    got = list(pose.build_dataset(pattern, normalize_on_host=False,
                                  **kw).batches(0))
    jwant = list(jpose.build_dataset(pattern, normalize_on_host=False,
                                     **kw).as_numpy_iterator())
    assert len(got) == len(want) == 2
    for g, w, wu in zip(got, want, jwant):
        assert g[0].dtype == torch.uint8
        assert _gap(g[0], wu[0]) <= DECODE_GAP + 1
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)


def test_cyclegan_records_end_to_end(data_root):
    a = os.path.join(data_root["cyclegan"], "toy", "trainA.tfrecord")
    b = os.path.join(data_root["cyclegan"], "toy", "trainB.tfrecord")
    want = list(jgan.build_two_domain_dataset(
        a, b, batch_size=2, image_size=24, training=False)
        .as_numpy_iterator())
    ds = gan_data.build_two_domain_dataset(a, b, batch_size=2, image_size=24,
                                           training=False)
    got = list(ds)
    assert len(got) == len(want) == ds.num_batches() == 2   # min(5, 4) // 2
    for (ga, gb), (wa, wb) in zip(got, want):
        assert _gap(ga, wa) <= DECODE_GAP / 127.5
        assert _gap(gb, wb) <= DECODE_GAP / 127.5


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("decode_only", [False, True])
def test_flat_loader_equals_jax(data_root, training, decode_only):
    """The flat loader draws JAX's randomness from the same generators:
    eval and training batches within a level of JAX's (PIL rounds
    between its two resize passes)."""
    kw = dict(batch_size=3, training=training, image_size=32,
              host_decode_only=decode_only)
    want = list(JaxFlat(data_root["flat"], data_root["synsets"], workers=2,
                        **kw))
    got = list(FlatImageNet(data_root["flat"], data_root["synsets"], **kw))
    assert len(got) == len(want) == (3 if training else 4)
    mean, std = _mean_std()
    # a level, normalised (f32 rounding aside); in training the jitter's
    # three factors (each at most 1.2) scale it by up to 1.2^3
    bound = ONE_LEVEL if decode_only else 1.001 / 255 / std.min()
    if training and not decode_only:
        bound *= 1.2 ** 3
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl.numpy(), wl)
        assert _gap(gi, wi) <= bound


def test_flat_loader_refuses_non_jpeg_files_on_the_card(tmp_path):
    """nvJPEG reads JPEG only: built for the card, the loader refuses a
    layout that holds PNGs (named .png, or .JPEG as one ILSVRC2012 train
    image is) before it decodes anything, naming them; on the CPU PIL
    decodes them, and the batches equal JAX's within a level."""
    root = str(tmp_path)
    synsets = fx.write_flat(root, n=4)
    rs = np.random.RandomState(3)
    for name in ("n01_8.png", "n02_9.JPEG"):
        (tmp_path / name).write_bytes(fx.png(fx.natural_image(40, 50, rs)))
    kw = dict(batch_size=3, training=False, image_size=32)
    with pytest.raises(NotJpegError,
                       match=r"2 file\(s\) .*: n01_8\.png, n02_9\.JPEG\."):
        FlatImageNet(root, synsets, device="cuda", **kw)
    got = list(FlatImageNet(root, synsets, device="cpu", **kw))
    want = list(JaxFlat(root, synsets, workers=2, **kw))
    assert len(got) == len(want) == 2
    mean, std = _mean_std()
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl.numpy(), wl)
        assert _gap(gi, wi) <= 1.001 / 255 / std.min()


# -- training pipelines: their contracts --------------------------------------

def test_distorted_crop_contract():
    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = rng.integers(20, 400, size=2)
        y, x, ch, cw = inet.distorted_crop((h, w), rng)
        assert 0 <= y and 0 <= x and y + ch <= h and x + cw <= w
        if (y, x, ch, cw) == (0, 0, h, w):
            continue
        assert 0.08 <= ch * cw / (h * w) <= 1.0
        assert 3 / 4 <= cw / ch <= 4 / 3
    # no crop of the aspect range fits a 2 x 500 strip: the whole image
    assert inet.distorted_crop((2, 500), rng) == (0, 0, 2, 500)


def test_imagenet_training_batches(data_root):
    pattern = os.path.join(data_root["imagenet"], "train*")
    kw = dict(batch_size=4, image_size=24, training=True, seed=3)
    ds = inet.build_dataset(pattern, **kw)
    it = ds.batches(0)
    batches = [next(it) for _ in range(6)]        # repeats past 17 records
    assert all(b[0].shape == (4, 24, 24, 3) for b in batches)
    again = inet.build_dataset(pattern, **kw).batches(0)
    for b in batches[:3]:
        a = next(again)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    other = next(inet.build_dataset(pattern, **kw).batches(1))
    assert not torch.equal(other[1], batches[0][1]) or not torch.equal(
        other[0], batches[0][0])
    labels = [int(v) for b in batches for v in b[1]]
    assert set(labels[:16]) <= set(range(17))


def test_flips_draw_half_the_time():
    rng = np.random.default_rng(1)
    flips = [inet.plan((50, 60), 16, True, rng).flip for _ in range(2000)]
    assert 0.45 <= np.mean(flips) <= 0.55
    boxes = np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)
    got = [det.random_flip(boxes, rng)[0] for _ in range(2000)]
    assert 0.45 <= np.mean(got) <= 0.55


def test_detection_flip_mirrors_and_crop_keeps_the_boxes():
    rng = np.random.default_rng(2)
    boxes = np.array([[0.1, 0.2, 0.3, 0.6], [0.5, 0.1, 0.9, 0.4]],
                     np.float32)
    flipped = None
    while flipped is None:
        did, out = det.random_flip(boxes, rng)
        if did:
            flipped = out
    np.testing.assert_allclose(flipped, [[0.7, 0.2, 0.9, 0.6],
                                         [0.1, 0.1, 0.5, 0.4]], atol=1e-6)
    crops = 0
    for _ in range(200):
        crop, new = det.random_crop_keep_boxes((80, 120), boxes, rng)
        if crop is None:
            np.testing.assert_array_equal(new, boxes)
            continue
        crops += 1
        y, x, ch, cw = crop
        assert 0 <= y and 0 <= x and y + ch <= 80 and x + cw <= 120
        assert new.min() >= -1e-6 and new.max() <= 1 + 1e-6
        # the renormalised boxes map back to the same image coordinates
        px = new[:, [0, 2]] * cw / 120 + x / 120
        assert np.abs(px - boxes[:, [0, 2]]).max() <= 1.5 / 120
    assert 70 <= crops <= 130


def test_detection_training_plan_flips_the_crop_of_the_mirror():
    """A flip then a crop of the mirrored image is the crop of the
    mirrored window, resized and flipped: the pixels of TensorFlow's
    order of operations."""
    rs = np.random.RandomState(4)
    img = torch.from_numpy(rs.randint(0, 256, (30, 40, 3)).astype(np.uint8))
    ex = det.Example(b"", (30, 40), np.array([[0.3, 0.3, 0.6, 0.7]],
                                             np.float32),
                     np.zeros(1, np.int32), np.zeros(1, np.float32))
    for seed in range(12):
        rng = np.random.default_rng(seed)
        plan, boxes = det.plan(ex, 16, True, rng)
        # TF's order by hand: flip, crop, resize
        rng = np.random.default_rng(seed)
        flip, b = det.random_flip(ex.boxes, rng)
        crop, _ = det.random_crop_keep_boxes(ex.shape, b, rng)
        mirror = img.flip(1) if flip else img
        y, x, ch, cw = crop or (0, 0, 30, 40)
        want = util.resize_image(mirror[y:y + ch, x:x + cw], (16, 16),
                                 "bilinear")
        got = util.resample_one(img, plan, (16, 16), "bilinear")
        assert float((got - want).abs().max()) <= 1e-3


def test_pose_crop_renormalises_and_keeps_missing_joints():
    kx = np.array([0.2, 0.6, -1.0, 0.4], np.float32)
    ky = np.array([0.3, 0.5, -1.0, 0.8], np.float32)
    crop, nx, ny = pose.crop_roi((100, 200), kx, ky, 0.2)
    y, x, ch, cw = crop
    assert nx[2] == -1.0 and ny[2] == -1.0
    ok = kx >= 0
    assert (nx[ok] >= 0).all() and (nx[ok] <= 1).all()
    assert (ny[ok] >= 0).all() and (ny[ok] <= 1).all()
    # back to the image: within a pixel of where they were
    assert np.abs(nx[ok] * cw / 200 + x / 200 - kx[ok]).max() <= 1.5 / 200
    assert np.abs(ny[ok] * ch / 100 + y / 100 - ky[ok]).max() <= 1.5 / 100
    # no joint at all: no crop, the whole image
    ex = pose.Example(b"", (50, 60), -np.ones(16, np.float32),
                      -np.ones(16, np.float32), np.zeros(16, np.float32))
    plan, (px, py, pv) = pose.plan(ex, 16, True, np.random.default_rng(0))
    assert plan.crop == (0, 0, 50, 60) and (px == -1).all()
    # fewer than 16 joints pad with -1
    assert list(pose.fix(np.array([0.5, 0.25]))[:3]) == [0.5, 0.25, -1.0]


def test_training_pipelines_are_seeded(data_root):
    for build, pattern in (
            (det.build_dataset, os.path.join(data_root["voc"], "train*")),
            (pose.build_dataset, os.path.join(data_root["mpii"],
                                              "train*"))):
        a = list(build(pattern, batch_size=2, image_size=24, seed=7)
                 .batches(0))
        b = list(build(pattern, batch_size=2, image_size=24, seed=7)
                 .batches(0))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for s, t in zip(x, y):
                assert torch.equal(s, t)
    a = os.path.join(data_root["cyclegan"], "toy", "trainA.tfrecord")
    b = os.path.join(data_root["cyclegan"], "toy", "trainB.tfrecord")
    runs = [list(gan_data.build_two_domain_dataset(
        a, b, batch_size=2, image_size=16, seed=1)) for _ in range(2)]
    for (p, q), (r, s) in zip(*runs):
        assert torch.equal(p, r) and torch.equal(q, s)


def test_color_jitter_is_jaxs():
    from deepvision_tpu.data.transforms import ColorJitter as JaxJitter
    rs = np.random.RandomState(5)
    imgs = rs.uniform(0, 255, (3, 8, 9, 3)).astype(np.float32)
    jit = JaxJitter(0.2, 0.2, 0.2)
    ours = ColorJitter(0.2, 0.2, 0.2)
    factors, want = [], []
    for i in range(3):
        want.append(jit(imgs[i], np.random.default_rng(i)))
        factors.append(ours.draw(np.random.default_rng(i)))
    got = ColorJitter.apply(torch.from_numpy(imgs), torch.tensor(factors))
    assert float(np.abs(got.numpy() - np.stack(want)).max()) <= 1e-3


def test_corrupt_records_raise_through_the_pipeline(tmp_path, data_root):
    src = os.path.join(data_root["imagenet"], "val-00000-of-00003")
    raw = bytearray(open(src, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    bad = tmp_path / "val-00000-of-00001"
    bad.write_bytes(bytes(raw))
    with pytest.raises(records.CorruptRecordError, match=str(bad)):
        list(inet.build_dataset(str(tmp_path / "val*"), batch_size=4,
                                image_size=16, training=False).batches(0))


def test_cuda_requests_never_fall_back_to_pil(monkeypatch):
    """On a CUDA device the decode goes to the decoder's library or
    raises: here the library cannot build (no nvcc) and the error says
    so."""
    from deepvision_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(jpeg, "_LIB", None)
    monkeypatch.setattr(_build, "_target", lambda name: _build.BUILD_DIR
                        / "no-such-library.so")
    data = fx.jpeg(fx.natural_image(20, 30, np.random.RandomState(0)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        jpeg.decode_batch([data], torch.device("cuda"))
    decoded = jpeg.decode_batch([data], torch.device("cpu"))
    assert tuple(decoded.image(0).shape) == (20, 30, 3)


def test_encode_cpu_round_trips():
    img = fx.natural_image(30, 20, np.random.RandomState(2))
    for sub in ("444", "422", "420"):
        data = jpeg.encode_jpeg(torch.from_numpy(img), 95, sub)
        assert data == jpeg.encode_cpu(img, 95, sub)
        # the noise (sigma 12) is what the quantisation takes away
        assert np.abs(jpeg.decode_cpu(data).astype(int) - img).mean() < 12
    buf = io.BytesIO(jpeg.encode_cpu(img[..., 0], 90))
    assert jpeg.extract_jpeg_shape(buf.getvalue()) == (30, 20, 1)


# -- --device-normalize: accepted and refused where the JAX CLI does ---------

@pytest.mark.parametrize("factory,model,dataset,augment,data", [
    ("_classification_data", "vit_small", "synthetic", False, None),
    ("_classification_data", "vit_small", "imagenet", False, "imagenet"),
    ("_classification_data", "vit_small", "imagenet_flat", False, "layout"),
    ("_classification_data", "vit_small", "imagenet_flat", True, "layout"),
    ("_detection_data", "yolov3", "synthetic", False, None),
    ("_detection_data", "yolov3_digits", "digits_detect", False, None),
    ("_detection_data", "yolov3_voc", "detection", False, "voc"),
    ("_detection_data", "centernet", "detection", False, "voc"),
    ("_pose_data", "hourglass104", "synthetic", False, None),
    ("_pose_data", "hourglass104", "pose", False, "mpii"),
    ("_segmentation_data", "unet_synthetic", "seg_synthetic", False, None),
])
def test_device_normalize_is_accepted_where_jax_accepts_it(
        data_root, tmp_path, factory, model, dataset, augment, data):
    import argparse
    import dataclasses

    from deepvision_tpu import cli as jax_cli
    from deepvision_tpu.configs import get_config as jax_get_config
    from deepvision_tpu_torch import cli
    from deepvision_tpu_torch.configs import get_config
    data_dir = data_root.get(data)
    if data == "layout":
        data_dir = str(tmp_path)
        for split in ("train_flatten", "val_flatten"):
            syn = fx.write_flat(os.path.join(data_dir, split), n=4)
        with open(os.path.join(data_dir, "synsets.txt"), "w") as fh:
            fh.write("\n".join(syn) + "\n")
    args = argparse.Namespace(synthetic=dataset == "synthetic",
                              data_dir=data_dir, steps_per_epoch=1,
                              device="cpu")
    outcomes = []
    for get, module in ((get_config, cli), (jax_get_config, jax_cli)):
        cfg = get(model)
        cfg = cfg.replace(batch_size=2, device_augment=augment,
                          data=dataclasses.replace(
                              cfg.data, dataset=dataset, image_size=32,
                              normalize_on_device=True))
        try:
            getattr(module, factory)(cfg, args)
            outcomes.append("accepted")
        except SystemExit as e:
            outcomes.append(("refused", "normalize" in str(e)
                             or "device-augment" in str(e)))
    assert outcomes[0] == outcomes[1], outcomes
