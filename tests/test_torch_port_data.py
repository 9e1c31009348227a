"""The port's data pipeline (`ldt_torch.data`) against `ldt_tpu.data` on a
fake PC15k tree: the same batches, bit for bit, for the same seed (the
seed-38383 shuffle of the clouds, their normalization, the loader's
per-epoch shuffle, the random 2048-point subsample), the same handling of
unreadable and wrong-shape files, and an iterator closed early."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ldt_torch.data import DataLoader, ShapeNet15kPointClouds
from ldt_torch.data import get_data_loaders as torch_loaders
from ldt_tpu.data import ShapeNet15kPointClouds as JaxShapeNet
from ldt_tpu.data import get_data_loaders as jax_loaders


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("PC15k")
    rng = np.random.RandomState(0)
    for synset, counts in (("02691156", (9, 5)), ("02958343", (4, 3))):
        for split, n in zip(("train", "val"), counts):
            d = root / synset / split
            d.mkdir(parents=True)
            for i in range(n):
                np.save(d / f"m{i}.npy",
                        (rng.randn(15000, 3) * 2 + 1).astype(np.float32))
    return str(root)


def _cfg(tree, **over):
    cfg = dict(cates=["airplane"], tr_max_sample_points=2048,
               te_max_sample_points=2048, data_dir=tree, boundary=True,
               batch_size=2, test_batch_size=3)
    cfg.update(over)
    return SimpleNamespace(**cfg)


def _same_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("seed,cates,boundary", [
    (0, ["airplane"], True), (3, ["airplane"], True),
    (38383, ["airplane", "car"], True), (7, ["car"], False)])
def test_batches_equal_the_jax_loaders_bit_for_bit(tree, seed, cates,
                                                   boundary):
    """Two epochs of the train loader (shuffled, subsampled, last partial
    batch dropped) and of the test loader."""
    cfg = _cfg(tree, seed=seed, cates=cates, boundary=boundary)
    args = SimpleNamespace(eval_split="val")
    want, got = jax_loaders(cfg, args), torch_loaders(cfg, args)
    for _ in range(2):
        for name in ("train_loader", "test_loader"):
            n = 0
            for a, b in zip(want[name], got[name], strict=True):
                _same_batches(a, b)
                n += 1
            assert n == len(got[name]) == len(want[name]) > 0


class _Counted:
    """A dataset that counts the items fetched from it."""

    def __init__(self, dataset):
        self.dataset, self.fetched = dataset, 0

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        item = self.dataset[i]  # its random draws done before the count
        self.fetched += 1
        return item


def test_an_iterator_closed_early_leaves_the_jax_stream(tree):
    """`next(iter(loader))` (the entries' first batch), then two epochs:
    the same batches as the JAX loader, whose abandoned thread goes on to
    make the batches it can prefetch (1 taken + 2 queued + 1 waiting); the
    port's makes those and stops, before `next` returns."""
    cfg = _cfg(tree, seed=5, batch_size=1)
    want, got = jax_loaders(cfg, {}), torch_loaders(cfg, {})
    jax_train = want["train_loader"]
    jax_train.dataset = _Counted(jax_train.dataset)
    got["train_loader"].dataset = _Counted(got["train_loader"].dataset)
    _same_batches(next(iter(jax_train)), next(iter(got["train_loader"])))
    assert got["train_loader"].dataset.fetched == 4
    deadline = time.monotonic() + 60
    while jax_train.dataset.fetched < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert jax_train.dataset.fetched == 4
    for _ in range(2):
        for a, b in zip(jax_train, got["train_loader"], strict=True):
            _same_batches(a, b)


def test_dataset_matches_and_skips_unreadable_files(tmp_path):
    d = tmp_path / "02691156" / "train"
    d.mkdir(parents=True)
    rng = np.random.RandomState(1)
    for i in range(3):
        np.save(d / f"m{i}.npy", rng.randn(15000, 3).astype(np.float64))
    (d / "m9.npy").write_bytes(b"not an array")
    kw = dict(root_dir=str(tmp_path), categories=["airplane"],
              split="train", tr_sample_size=128, te_sample_size=64,
              random_subsample=True)
    got, want = ShapeNet15kPointClouds(**kw), JaxShapeNet(**kw)
    assert len(got) == len(want) == 3
    assert np.array_equal(got.all_points, want.all_points)
    for i in range(3):
        _same_batches(got[i], want[i])
    np.save(d / "m5.npy", np.zeros((14999, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        ShapeNet15kPointClouds(**kw)


def test_loader_raises_a_dataset_error():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("item 2")
            return {"x": np.zeros(2, np.float32)}

    loader = DataLoader(Bad(), batch_size=1)
    with pytest.raises(KeyError, match="item 2"):
        list(loader)
    assert not any(t.name == "ldt-loader" for t in threading.enumerate())
