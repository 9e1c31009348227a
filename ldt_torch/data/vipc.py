"""ShapeNet-ViPC completion data (a view image, the GT cloud, a partial
cloud), counterpart of `ldt_tpu/data/vipc.py` with the same items for the
same `random` state:

  * the list file's lines `<synset>;<model>;<view>`, filtered by category
    (`CAT_MAP`); a malformed line (the view glued to the model name) split
    as the reference does (`_split`);
  * `preload=True`: every model's 24 views and GT clouds read once, keyed by
    the view id, only where both files exist; `view_align` then fetches the
    list line's own view, else a random one of those loaded;
  * `preload=False`: each fetch reads the GT cloud and the view of a random
    view id (0-23; `view_align`: the line's own);
  * the random view from Python's global `random` (a worker pool makes its
    order follow thread timing: compare items with `num_workers=0`);
  * the partial cloud pad-repeated (or cut) to `pc_input_num` (3500);
  * the partial cloud rotated from its view to the image's through the
    angles of `rendering/rendering_metadata.txt`;
  * both clouds normalized by the GT's centroid and its largest radius.

Views are read by `data.png.load_view` (no PIL: the short side resized to
224 as PIL's bilinear `Resize(224)`, channels-last float32 in [0, 1]); the
`.dat` files are pickles of numpy arrays. `get_data_loaders(cfg)` gives the
train loader (shuffled with `cfg.seed`, default 0) and the test loader, on
`data.loader.DataLoader`, with `cfg.num_workers` item threads where a split
is not preloaded. The configs' `data.type: ldt_tpu.data.vipc` names this
module.
"""

from __future__ import annotations

import math
import os
import pickle
import random
from typing import Dict

import numpy as np

from ldt_torch.data.loader import DataLoader
from ldt_torch.data.png import load_view

CAT_MAP = {
    "plane": "02691156", "bench": "02828884", "cabinet": "02933112",
    "car": "02958343", "chair": "03001627", "monitor": "03211117",
    "lamp": "03636649", "speaker": "03691459", "firearm": "04090263",
    "couch": "04256520", "table": "04379243", "cellphone": "04401088",
    "watercraft": "04530566",
}
VIEWS = 24  # renderings per model in ShapeNet-ViPC


def rotation_x(pts, theta):
    c, s = np.cos(theta), np.sin(theta)
    m = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return pts @ m.T


def rotation_y(pts, theta):
    c, s = np.cos(theta), np.sin(theta)
    m = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    return pts @ m.T


def rotation_z(pts, theta):
    c, s = np.cos(theta), np.sin(theta)
    m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return pts @ m.T


def _load_dat(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return pickle.load(f).astype(np.float32)


class ViPCDataLoader:
    """Map-style dataset of {views, pc, pc_part} dicts (see the module
    docstring)."""

    def __init__(self, filepath, data_path, status, pc_input_num=3500,
                 view_align=False, category="all", preload=True):
        self.pc_input_num = pc_input_num
        self.status = status
        self.view_align = view_align
        self.category = category
        self.imcomplete_path = os.path.join(data_path, "ShapeNetViPC-Partial")
        self.gt_path = os.path.join(data_path, "ShapeNetViPC-GT")
        self.rendering_path = os.path.join(data_path, "ShapeNetViPC-View")
        with open(filepath, "r") as f:
            filelist = [line for line in f if line.strip()]
        self.cat, self.key = [], []
        for key in filelist:
            if category != "all" and key.split(";")[0] != CAT_MAP[category]:
                continue
            self.cat.append(key.split(";")[0])
            self.key.append(key)
        print(f"{status} data num: {len(self.key)}")
        self.preload = preload
        if preload:
            # model -> {view id: (GT cloud, view)}, where both files exist;
            # keyed by the view id, so an aligned fetch and the metadata
            # read stay right when a view is missing
            self.all_views: Dict[str, Dict[int, tuple]] = {}
            self.view_ids: Dict[str, list] = {}
            for key in self.key:
                file_name = key.split(";")[1]
                if file_name in self.all_views:
                    continue
                self.all_views[file_name] = {}
                for i in range(VIEWS):
                    ran_key = key[:-3] + str(i).rjust(2, "0")
                    synset, mid, view = self._split(ran_key)
                    pc_path = os.path.join(self.gt_path, synset, mid,
                                           view + ".dat")
                    view_path = os.path.join(self.rendering_path, synset, mid,
                                             "rendering", view + ".png")
                    if os.path.exists(pc_path) and os.path.exists(view_path):
                        self.all_views[file_name][i] = (
                            _load_dat(pc_path), load_view(view_path))
                    elif not os.path.exists(pc_path):
                        print(pc_path + " missing")
                self.view_ids[file_name] = sorted(self.all_views[file_name])

    @staticmethod
    def _split(key):
        """(synset, model, view) of a list line; a malformed line's view
        glued to the model name (the last field longer than 3) is cut
        off it."""
        parts = key.replace("\n", "").split(";")
        synset, mid, view = parts[0], parts[1], parts[-1]
        if len(view) > 3:
            mid, view = view[:-2], view[-2:]
        return synset, mid, view

    def __len__(self):
        return len(self.key)

    def __getitem__(self, idx):
        key = self.key[idx]
        synset, mid, view = self._split(key)
        pc_part_path = os.path.join(self.imcomplete_path, synset, mid,
                                    view + ".dat")
        if self.preload:
            file_name = key.split(";")[1]
            if self.view_align:
                ran = int(view)
                if ran not in self.all_views[file_name]:
                    raise KeyError(
                        f"view_align: view {view} of {file_name} was not "
                        "preloaded (missing gt/.png on disk)")
            else:
                ids = self.view_ids[file_name]
                ran = ids[random.randint(0, len(ids) - 1)] if ids else 0
            pc, views = self.all_views[file_name][ran]
            image_view_id = str(ran).rjust(2, "0")
        else:
            ran_key = key if self.view_align else \
                key[:-3] + str(random.randint(0, VIEWS - 1)).rjust(2, "0")
            s2, m2, v2 = self._split(ran_key)
            pc = _load_dat(os.path.join(self.gt_path, s2, m2, v2 + ".dat"))
            views = load_view(os.path.join(self.rendering_path, s2, m2,
                                           "rendering", v2 + ".png"))
            image_view_id = v2
        pc_part = _load_dat(pc_part_path)

        # pad-repeat a short partial cloud, cut a long one
        if pc_part.shape[0] < self.pc_input_num:
            pc_part = np.repeat(
                pc_part, (self.pc_input_num // pc_part.shape[0]) + 1,
                axis=0)[: self.pc_input_num]
        else:
            pc_part = pc_part[: self.pc_input_num]

        # from the partial cloud's view to the image's, by the angles of the
        # metadata file inside rendering/
        meta_path = os.path.join(self.rendering_path, synset, mid,
                                 "rendering", "rendering_metadata.txt")
        view_metadata = np.loadtxt(meta_path)
        theta_part = math.radians(view_metadata[int(view), 0])
        phi_part = math.radians(view_metadata[int(view), 1])
        theta_img = math.radians(view_metadata[int(image_view_id), 0])
        phi_img = math.radians(view_metadata[int(image_view_id), 1])
        pc_part = rotation_y(rotation_x(pc_part, -phi_part),
                             np.pi + theta_part)
        pc_part = rotation_x(rotation_y(pc_part, np.pi - theta_img), phi_img)

        # both clouds by the GT's centroid and largest radius
        gt_mean = pc.mean(axis=0)
        pc = pc - gt_mean
        pc_l_max = np.max(np.sqrt(np.sum(np.abs(pc ** 2), axis=-1)))
        pc = pc / pc_l_max
        pc_part = (pc_part - gt_mean) / pc_l_max
        return {
            "views": views.astype(np.float32),
            "pc": pc.astype(np.float32),
            "pc_part": pc_part.astype(np.float32),
        }


def get_data_loaders(cfg):
    """{'train_loader', 'test_loader'} of the `data:` config section (the
    list files `train_list` / `test_list`, default the reference's
    `datasets/ViPC/{train,test}_list2.txt`)."""
    tr_dataset = ViPCDataLoader(
        getattr(cfg, "train_list", "datasets/ViPC/train_list2.txt"),
        cfg.data_dir, status="train", category=cfg.train_cate,
        preload=cfg.train_preload)
    te_dataset = ViPCDataLoader(
        getattr(cfg, "test_list", "datasets/ViPC/test_list2.txt"),
        cfg.data_dir, status="test", category=cfg.test_cate,
        preload=cfg.test_preload)
    workers = int(getattr(cfg, "num_workers", 4) or 0)
    train_loader = DataLoader(tr_dataset, batch_size=cfg.batch_size,
                              shuffle=True, drop_last=False,
                              seed=getattr(cfg, "seed", 0),
                              num_workers=0 if cfg.train_preload else workers)
    test_loader = DataLoader(te_dataset, batch_size=cfg.test_batch_size,
                             shuffle=False, drop_last=False,
                             num_workers=0 if cfg.test_preload else workers)
    return {"train_loader": train_loader, "test_loader": test_loader}
