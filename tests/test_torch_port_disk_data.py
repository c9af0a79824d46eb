"""The port's disk datasets against the JAX package's, on the CPU.

Mirrors ``tests/test_disk_data.py``. On the same written files (a 3-class
tree of 4 JPEGs a class, 40 x 48; a uint16 corpus of 16,005 tokens) the
port's ``ImageFolderDataset`` and ``TokenBinDataset`` give the JAX
module's arrays exactly: the scan order and labels, the decode, the train
transform at every (index, epoch), the eval transform, the windows and
the range check. Through torch's ``DataLoader`` (which the port's entry
points use) a 2-worker stream equals the in-process one, a worker's
exception reaches the caller, and a ``TokenBinDataset`` of a custom dtype
survives pickling and spawned workers. The entry points' use of these
datasets (``--data-dir``, ``--data-bin``) is tested in
``tests/test_torch_port_resnet_example.py`` and
``tests/test_torch_port_trainer.py``. The reference's wall-clock
worker-scaling test has no counterpart here: a timing test is unsteady
under a parallel test run.
"""

import pickle

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader

from pytorch_distributed_tpu_torch.data import (
    DistributedSampler,
    ImageFolderDataset,
    TokenBinDataset,
    make_image_transform,
    write_image_folder,
    write_token_bin,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    write_image_folder(str(root), n_classes=3, per_class=4, size=(40, 48))
    return str(root)


@pytest.fixture(scope="module")
def token_bin(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "corpus.bin"
    rng = np.random.default_rng(0)
    write_token_bin(str(path), rng.integers(0, 50257, 1000 * 16 + 5))
    return str(path)


def test_writers_write_the_references_files(tmp_path):
    from pytorch_distributed_tpu.data import disk as jax_disk

    for mod, sub in ((jax_disk, "jax"), (None, "port")):
        root = tmp_path / sub
        (mod.write_image_folder if mod else write_image_folder)(
            str(root / "img"), n_classes=2, per_class=3, size=(20, 24),
            seed=5)
        (mod.write_token_bin if mod else write_token_bin)(
            str(root / "c.bin"), range(300, 400), dtype=np.uint32)
    for f in sorted((tmp_path / "jax").rglob("*")):
        if f.is_file():
            twin = tmp_path / "port" / f.relative_to(tmp_path / "jax")
            assert twin.read_bytes() == f.read_bytes(), f


def test_image_folder_equals_the_references(image_root):
    from pytorch_distributed_tpu.data import ImageFolderDataset as JaxIF

    ours, ref = ImageFolderDataset(image_root), JaxIF(image_root)
    assert ours.classes == ref.classes == ["class_0", "class_1", "class_2"]
    assert ours.samples == ref.samples
    for i in range(len(ref)):
        (x, y), (xr, yr) = ours[i], ref[i]
        assert x.dtype == np.float32 and x.shape == (40, 48, 3)
        np.testing.assert_array_equal(x, xr)
        assert y == yr and type(y) is type(yr)


@pytest.mark.parametrize("train,size", [(True, 32), (False, 24)])
def test_transforms_equal_the_references(image_root, train, size):
    from pytorch_distributed_tpu.data import ImageFolderDataset as JaxIF
    from pytorch_distributed_tpu.data import (
        make_image_transform as jax_transform,
    )

    ours = ImageFolderDataset(image_root, transform=make_image_transform(
        size, train=train, seed=7))
    ref = JaxIF(image_root, transform=jax_transform(size, train=train,
                                                    seed=7))
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            x, xr = ours[i][0], ref[i][0]
            assert x.shape == (size, size, 3)
            np.testing.assert_array_equal(x, xr)
    if train:     # fresh draws each epoch, the same draws for an epoch
        ours.set_epoch(0)
        a = ours[3][0]
        ours.set_epoch(1)
        assert not np.array_equal(a, ours[3][0])


def test_token_windows_equal_the_references(token_bin, tmp_path):
    from pytorch_distributed_tpu.data import TokenBinDataset as JaxTB

    ours, ref = TokenBinDataset(token_bin, 16), JaxTB(token_bin, 16)
    assert len(ours) == len(ref) == 1000
    for i in (0, 1, 517, 999):
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    x, y = ours[0]
    np.testing.assert_array_equal(x[1:], y[:-1])
    TokenBinDataset(token_bin, 16, vocab_size=50257)
    with pytest.raises(ValueError, match="mismatch"):
        TokenBinDataset(token_bin, 16, vocab_size=100)
    tiny = tmp_path / "tiny.bin"
    write_token_bin(str(tiny), [1, 2, 3])
    with pytest.raises(ValueError, match="window"):
        TokenBinDataset(str(tiny), seq_len=16)


def test_two_worker_stream_equals_in_process(image_root):
    ds = ImageFolderDataset(image_root, transform=make_image_transform(
        16, train=True, seed=1))
    base = list(DataLoader(ds, batch_size=5))
    multi = list(DataLoader(ds, batch_size=5, num_workers=2,
                            multiprocessing_context="spawn"))
    assert len(base) == len(multi) == 3
    for (x0, y0), (x1, y1) in zip(base, multi):
        assert torch.equal(x0, x1) and torch.equal(y0, y1)


class _Poisoned:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("poison index")
        return np.int32(i)


def test_worker_exception_propagates():
    with pytest.raises(KeyError, match="poison index"):
        list(DataLoader(_Poisoned(), batch_size=2, num_workers=2,
                        multiprocessing_context="spawn"))


def test_custom_dtype_survives_spawn(tmp_path, token_bin):
    p = tmp_path / "u32.bin"
    write_token_bin(str(p), list(range(100_000, 100_000 + 40)),
                    dtype=np.uint32)
    ds = TokenBinDataset(str(p), seq_len=8, dtype=np.uint32)
    ds2 = pickle.loads(pickle.dumps(ds))
    np.testing.assert_array_equal(ds2[0][0], ds[0][0])
    assert len(ds2) == len(ds) == 4   # a uint16 reading would double it
    batches = list(DataLoader(ds, batch_size=2, num_workers=2,
                              multiprocessing_context="spawn"))
    assert torch.equal(torch.cat([x for x, _ in batches]),
                       torch.from_numpy(np.stack([ds[i][0]
                                                  for i in range(4)])))
    # the port's sampler shards the windows disjointly over 4 ranks
    seen = set()
    for rank in range(4):
        sampler = DistributedSampler(TokenBinDataset(token_bin, 16),
                                     num_replicas=4, rank=rank, seed=3)
        seen.update(sampler)
    assert seen == set(range(1000))
