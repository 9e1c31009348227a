"""ShapeNetCore.v2.PC15k point clouds, counterpart of
`ldt_tpu/data/shapenet55.py`, with the same semantics and the same batches
for the same seed:

  * the synset-id <-> category maps;
  * every `<root>/<synset>/<split>/*.npy` (15000 x 3) loaded at once by the
    native bulk loader (`data.fastload`, np.load for a file it rejects):
    unreadable files are skipped, a readable file of another shape raises;
  * the deterministic shuffle `random.Random(38383)`;
  * per-cloud unit-sphere normalization, keeping each cloud's shift and
    scale;
  * `tr_points` a random subsample of the whole 15k cloud (train split:
    `random_subsample`), `te_points` from its last 5000 points, each item's
    draws from one RandomState(0) in item order;
  * `get_data_loaders(cfg, args)`: the train loader shuffled with
    `cfg.seed` (default 0) and dropping the last partial batch, the test
    loader in order.
"""

from __future__ import annotations

import os
import random

import numpy as np

from ldt_torch.data.fastload import load_npy_batch
from ldt_torch.data.loader import DataLoader

synsetid_to_cate = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "can", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "monitor",
    "04379243": "table", "04401088": "telephone", "02946921": "tin_can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "speaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwave", "03790512": "motorcycle", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "pot", "04004475": "printer", "04074963": "remote_control",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "vessel",
    "04554684": "washer", "02992529": "cellphone",
    "02843684": "birdhouse", "02871439": "bookshelf",
}
cate_to_synsetid = {v: k for k, v in synsetid_to_cate.items()}

CLOUD_SHAPE = (15000, 3)


def normalize_point_cloud(inputs: np.ndarray):
    """Each of [N, P, 3] clouds centred and scaled to the unit sphere:
    (clouds, [centroid, furthest])."""
    centroid = np.mean(inputs, axis=1, keepdims=True)
    pc = inputs - centroid
    furthest = np.amax(np.sqrt(np.sum(pc ** 2, axis=-1, keepdims=True)),
                       axis=1, keepdims=True)
    return pc / furthest, [centroid, furthest]


def _load_clouds(paths):
    """[n, 15000, 3] float32 of the readable files, and which were, through
    the native bulk loader (`data.fastload`); a readable file of another
    shape raises."""
    return load_npy_batch(paths, CLOUD_SHAPE, strict_shape=True)


class Uniform15KPC:
    """RAM-resident 15k-point clouds of the `subdirs` synsets."""

    def __init__(self, root_dir, subdirs, tr_sample_size=10000,
                 te_sample_size=10000, split="train",
                 random_subsample=False, boundary=True, rng_seed=0):
        self.root_dir = root_dir
        self.split = split
        self.subdirs = subdirs
        self.random_subsample = random_subsample
        self.input_dim = 3
        self._rng = np.random.RandomState(rng_seed)
        entries = []  # (path, cate_idx, (subd, mid))
        for cate_idx, subd in enumerate(subdirs):
            sub_path = os.path.join(root_dir, subd, split)
            if not os.path.isdir(sub_path):
                print(f"Directory missing : {sub_path}")
                continue
            for x in sorted(os.listdir(sub_path)):
                if x.endswith(".npy"):
                    mid = os.path.join(split, x[:-len(".npy")])
                    entries.append((os.path.join(root_dir, subd, mid + ".npy"),
                                    cate_idx, (subd, mid)))
        block, ok = _load_clouds([e[0] for e in entries])
        keep = np.nonzero(ok)[0]
        cate_idx_lst = [entries[i][1] for i in keep]
        all_cate_mids = [entries[i][2] for i in keep]

        self.shuffle_idx = list(range(len(keep)))
        random.Random(38383).shuffle(self.shuffle_idx)
        self.cate_idx_lst = [cate_idx_lst[i] for i in self.shuffle_idx]
        self.all_cate_mids = [all_cate_mids[i] for i in self.shuffle_idx]

        self.all_points = block[keep[self.shuffle_idx]] if len(keep) \
            else np.zeros((0,) + CLOUD_SHAPE, np.float32)
        if boundary and len(self.all_points):
            self.all_points, [self.per_points_shift, self.per_points_scale] = \
                normalize_point_cloud(self.all_points)
        else:
            # [N, 1, 3] placeholders: an item's `scale` is then [1, 3],
            # where normalization gives [1, 1], as in the JAX package
            n = self.all_points.shape[0]
            self.per_points_shift = np.zeros((n, 1, 3), np.float32)
            self.per_points_scale = np.ones((n, 1, 3), np.float32)

        self.train_points = self.all_points[:, :10000]
        self.test_points = self.all_points[:, 10000:]
        self.tr_sample_size = min(10000, tr_sample_size)
        self.te_sample_size = min(5000, te_sample_size)
        print(f"Total number of data:{len(self.train_points)}")
        print(f"Min number of points: (train){self.tr_sample_size} "
              f"(test){self.te_sample_size}")

    def get_standardize_stats(self, idx):
        shift = self.per_points_shift[idx].reshape(1, self.input_dim)
        scale = self.per_points_scale[idx].reshape(1, -1)
        return shift, scale

    def __len__(self):
        return len(self.train_points)

    def __getitem__(self, idx):
        # training points subsample the whole 15k cloud, not its first 10k
        tr_out = self.all_points[idx]
        if self.random_subsample:
            tr_idxs = self._rng.choice(tr_out.shape[0], self.tr_sample_size)
        else:
            tr_idxs = np.arange(self.tr_sample_size)
        tr_out = tr_out[tr_idxs, :].astype(np.float32)
        te_out = self.test_points[idx]
        if self.random_subsample:
            te_idxs = self._rng.choice(te_out.shape[0], self.te_sample_size)
        else:
            te_idxs = np.arange(self.te_sample_size)
        te_out = te_out[te_idxs, :].astype(np.float32)
        sid, mid = self.all_cate_mids[idx]
        shift, scale = self.get_standardize_stats(idx)
        return {
            "idx": idx,
            "tr_points": tr_out,
            "te_points": te_out,
            "cate_idx": self.cate_idx_lst[idx],
            "sid": sid, "mid": mid,
            "shift": shift.astype(np.float32),
            "scale": scale.astype(np.float32),
        }


class ShapeNet15kPointClouds(Uniform15KPC):
    """The clouds of `categories` (names, or "all")."""

    def __init__(self, root_dir="data/ShapeNetCore.v2.PC15k",
                 categories=("airplane",), tr_sample_size=10000,
                 te_sample_size=2048, split="train", random_subsample=False,
                 boundary=True):
        if split not in ("train", "test", "val"):
            raise ValueError(f"split {split!r}: expected train, test or val")
        self.cates = list(categories)
        if "all" in self.cates:
            synset_ids = list(cate_to_synsetid.values())
        else:
            synset_ids = [cate_to_synsetid[c] for c in self.cates]
        super().__init__(root_dir, synset_ids, tr_sample_size=tr_sample_size,
                         te_sample_size=te_sample_size, split=split,
                         random_subsample=random_subsample, boundary=boundary)


def get_datasets(cfg, args):
    """(train, eval) datasets of the `data:` config section; the eval split
    is `args.eval_split` (default "val")."""
    tr_dataset = ShapeNet15kPointClouds(
        categories=cfg.cates, split="train",
        tr_sample_size=cfg.tr_max_sample_points,
        te_sample_size=cfg.te_max_sample_points,
        root_dir=cfg.data_dir, random_subsample=True, boundary=cfg.boundary)
    te_dataset = ShapeNet15kPointClouds(
        categories=cfg.cates, split=getattr(args, "eval_split", "val"),
        tr_sample_size=cfg.tr_max_sample_points,
        te_sample_size=cfg.te_max_sample_points,
        root_dir=cfg.data_dir, boundary=cfg.boundary)
    return tr_dataset, te_dataset


def get_data_loaders(cfg, args):
    """{'train_loader', 'test_loader'} of the `data:` config section."""
    tr_dataset, te_dataset = get_datasets(cfg, args)
    train_loader = DataLoader(tr_dataset, batch_size=cfg.batch_size,
                              shuffle=True, drop_last=True,
                              seed=getattr(cfg, "seed", 0))
    test_loader = DataLoader(te_dataset, batch_size=cfg.test_batch_size,
                             shuffle=False, drop_last=False)
    return {"train_loader": train_loader, "test_loader": test_loader}
