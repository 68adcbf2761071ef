"""The port's prefetcher (deepvision_tpu_torch/parallel/prefetch.py) on the
CPU: batches in order through the producer thread and inline, producer
errors re-raised at the consumer, `close()` mid-stream, the transfer
ledger, and the trainer staging its epochs through it. The card's side
(pinned buffers, the side stream, no buffer reused early) is in
tests/test_torch_cuda.py."""

import threading

import numpy as np
import pytest
import torch

from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.data.synthetic import SyntheticClassification
from deepvision_tpu_torch.parallel.prefetch import (DevicePrefetcher,
                                                    prefetch_to_device)


def _batches(n, dtype=np.float32):
    for i in range(n):
        yield (np.full((2, 3), i, dtype), np.arange(2, dtype=np.int32) + i)


def _threads():
    return [t for t in threading.enumerate() if t.name == "device-prefetch"]


@pytest.mark.parametrize("size", [1, 2, 4])
def test_order_is_kept(size):
    staged = prefetch_to_device(_batches(7), size)
    got = [(int(x[0, 0]), int(y[0])) for x, y in staged]
    staged.close()
    assert got == [(i, i) for i in range(7)]
    assert staged.batches_staged_total == 7
    assert all(not t.is_alive() for t in _threads())


def test_size_one_stages_inline_without_a_thread():
    before = len(_threads())
    staged = DevicePrefetcher(_batches(3), size=1)
    assert staged._thread is None and len(_threads()) == before
    x, _ = next(staged)
    assert isinstance(x, torch.Tensor) and int(x[0, 0]) == 0
    assert staged.queue_depth == 0
    staged.close()
    with pytest.raises(StopIteration):
        next(staged)
    # inline staging is all wait: nothing overlapped
    assert staged.overlapped_fraction == 0.0


@pytest.mark.parametrize("size", [1, 3])
def test_producer_error_reraises_at_the_consumer(size):
    def broken():
        yield from _batches(2)
        raise OSError("disk went away")

    staged = prefetch_to_device(broken(), size)
    assert [int(x[0, 0]) for x, _ in (next(staged), next(staged))] == [0, 1]
    with pytest.raises(OSError, match="disk went away"):
        next(staged)
    staged.close()


def test_close_mid_stream_stops_the_thread_and_drains():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield (np.full((2,), i, np.float32),)
            i += 1

    staged = prefetch_to_device(endless(), 3)
    next(staged)
    staged.close(timeout=10)
    assert not staged._thread.is_alive()
    assert staged.queue_depth == 0
    count = len(pulled)
    assert count <= 1 + 3 + 1          # the consumer's, size staged, one
    with pytest.raises(StopIteration):
        next(staged)


def test_ledger_counts_host_bytes_uint8_a_quarter_of_f32():
    f32 = prefetch_to_device(_batches(4, np.float32), 2)
    list(f32)
    f32.close()
    u8 = prefetch_to_device(_batches(4, np.uint8), 2)
    list(u8)
    u8.close()
    labels = 4 * 2 * 4
    assert f32.bytes_staged_total == 4 * 6 * 4 + labels
    assert u8.bytes_staged_total - labels == (f32.bytes_staged_total
                                              - labels) // 4
    ledger = u8.ledger()
    assert ledger["batches_staged_total"] == 4
    assert ledger["bytes_per_sec"] > 0
    assert 0.0 <= ledger["overlapped_fraction"] <= 1.0
    assert ledger["wait_secs_total"] >= ledger["first_wait_secs"] >= 0


@pytest.mark.parametrize("prefetch", [1, 2])
def test_trainer_stages_its_epochs_through_the_prefetcher(tmp_path,
                                                          prefetch):
    cfg = get_config("lenet5").replace(batch_size=4,
                                       prefetch_batches=prefetch)
    trainer = Trainer(cfg, device="cpu", workdir=str(tmp_path))
    trainer.init_state()
    out = trainer.train_epoch(1, SyntheticClassification(4, 32, 1, 10, 3,
                                                         seed=0))
    trainer.close()
    assert len(trainer.last_epoch_steps) == 3 and np.isfinite(out["loss"])
    ledger = trainer.last_prefetch_ledger
    assert ledger["batches_staged_total"] == 3
    assert ledger["bytes_staged_total"] == 3 * (4 * 32 * 32 * 4 + 4 * 4)
    assert all(not t.is_alive() for t in _threads())


@pytest.mark.parametrize("size", [1, 2])
def test_batches_already_on_the_device_pass_through(size):
    """A batch the record loaders built on the device is not staged again:
    the same tensors come out, and the ledger counts 0 bytes for them (a
    mixed batch counts only its host arrays)."""
    on_device = [(torch.full((2, 3), i, dtype=torch.uint8),
                  torch.arange(2, dtype=torch.int32) + i) for i in range(3)]
    staged = prefetch_to_device(iter(on_device), size, torch.device("cpu"))
    got = list(staged)
    staged.close()
    assert all(a is b for g, w in zip(got, on_device) for a, b in zip(g, w))
    assert staged.bytes_staged_total == 0
    assert staged.batches_staged_total == 3
    mixed = [(torch.zeros((2, 3)), np.zeros((2,), np.int32))]
    staged = prefetch_to_device(iter(mixed), size, torch.device("cpu"))
    (x, y), = list(staged)
    staged.close()
    assert x is mixed[0][0] and isinstance(y, torch.Tensor)
    assert staged.bytes_staged_total == 8
