"""The traffic generator is deterministic in the seed, gives every seed
the same amount of work, and writes nothing to disk."""

import torch

from cardbench import traffic
from cardbench.tests.conftest import small_cell


def test_frames_repeat_for_a_seed_and_differ_across_seeds():
    a = traffic.make_frames(2**31 + 5, 3, 20, 64, 96, "cpu")
    b = traffic.make_frames(2**31 + 5, 3, 20, 64, 96, "cpu")
    c = traffic.make_frames(2**31 + 6, 3, 20, 64, 96, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (20, 64, 96, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_any_rows_of_a_batch_are_the_same_frames():
    whole = traffic.make_frames(9, 0, 40, 32, 32, "cpu")
    part = traffic.make_frames(9, 13, 20, 32, 32, "cpu")
    assert torch.equal(whole[13:33], part)


def test_pool_batches_are_consecutive_frames_of_the_seed():
    tr = small_cell("litepi-v2.card-b256").traffic | {"height": 32, "width": 48}
    pool = traffic.device_pool(tr, 2**33 + 1, "cpu")
    assert len(pool) == tr["pool"] and pool[0].shape == (tr["batch"], 32, 48, 3)
    again = traffic.make_frames(2**33 + 1, 0, tr["pool"] * tr["batch"], 32, 48, "cpu")
    assert torch.equal(torch.cat(pool), again)
    other = traffic.device_pool(tr, 2**33 + 2, "cpu")
    assert not torch.equal(pool[0], other[0])


def test_generator_writes_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tr = {"batch": 4, "pool": 2, "height": 24, "width": 40}
    pool = traffic.device_pool(tr, 3, "cpu")
    assert pool[1].shape == (4, 24, 40, 3)
    assert list(tmp_path.iterdir()) == []
