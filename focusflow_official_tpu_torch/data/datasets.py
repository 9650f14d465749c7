"""Flow datasets with mirrored keypoint-mask trees.

Each dataset walks the reference's directory layout (including the custom
Sintel-custom / KITTI-custom split directories) and pairs every (frame_t,
frame_t+1) with its flow and the two keypoint masks from
`mask/<dataset>/<mask_type>/...`.

- Samples are NHWC numpy dicts: `image1`, `image2` (H, W, 3), `flow`
  (H, W, 2), `mask1`, `mask2` (H, W, 1), `valid` (H, W), all float32; a
  test split gives the images, the masks and `extra_info`.
- Curriculum oversampling (`100 * sintel_clean + things` in the reference)
  is `WeightedConcat` index arithmetic, with no list copied.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

from .augment import FlowAugmentor, SparseFlowAugmentor
from .io import read_flow_kitti, read_gen


class FlowDataset:
    """Base: image/flow/mask path lists + per-sample load/augment."""

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False,
                 seed: Optional[int] = None):
        self.sparse = sparse
        self.augmentor = None
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params, seed=seed)
        self.is_test = False
        self.flow_list: List[str] = []
        self.image_list: List[List[str]] = []
        self.mask_list: List[List[str]] = []
        self.extra_info: List = []

    def __len__(self) -> int:
        return len(self.image_list)

    def _load_mask(self, path: str) -> np.ndarray:
        m = np.asarray(read_gen(path)).astype(np.uint8)
        if m.ndim == 2:
            m = m[..., None]
        else:
            m = m[..., :1]
        return m

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        index = index % len(self.image_list)
        img1 = np.asarray(read_gen(self.image_list[index][0])).astype(np.uint8)
        img2 = np.asarray(read_gen(self.image_list[index][1])).astype(np.uint8)
        mask1 = self._load_mask(self.mask_list[index][0])
        mask2 = self._load_mask(self.mask_list[index][1])

        if self.is_test:
            return {
                "image1": img1[..., :3].astype(np.float32),
                "image2": img2[..., :3].astype(np.float32),
                "mask1": mask1.astype(np.float32),
                "mask2": mask2.astype(np.float32),
                "extra_info": self.extra_info[index],
            }

        valid = None
        if self.sparse:
            flow, valid = read_flow_kitti(self.flow_list[index])
        else:
            flow = np.asarray(read_gen(self.flow_list[index])).astype(np.float32)

        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1, img2 = img1[..., :3], img2[..., :3]

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid, mask1, mask2 = self.augmentor(
                    img1, img2, flow, valid, mask1, mask2
                )
            else:
                img1, img2, flow, mask1, mask2 = self.augmentor(
                    img1, img2, flow, mask1, mask2
                )

        if valid is None:
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)

        return {
            "image1": img1.astype(np.float32),
            "image2": img2.astype(np.float32),
            "flow": flow.astype(np.float32),
            "mask1": mask1.astype(np.float32),
            "mask2": mask2.astype(np.float32),
            "valid": np.asarray(valid).astype(np.float32),
        }


class MpiSintel(FlowDataset):
    def __init__(self, root, mask_root, aug_params=None, split="training",
                 dstype="clean", mask_type="orb", seed=None):
        super().__init__(aug_params, seed=seed)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        mask_root = osp.join(mask_root, mask_type, split, dstype)
        if split == "testing":
            self.is_test = True

        for scene in sorted(os.listdir(image_root)):
            images = sorted(glob(osp.join(image_root, scene, "*.png")))
            masks = sorted(glob(osp.join(mask_root, scene, "*.png")))
            for i in range(len(images) - 1):
                self.image_list.append([images[i], images[i + 1]])
                self.mask_list.append([masks[i], masks[i + 1]])
                self.extra_info.append((scene, i))
            if split != "test":
                self.flow_list += sorted(glob(osp.join(flow_root, scene, "*.flo")))


class FlyingChairs(FlowDataset):
    def __init__(self, root, mask_root, aug_params=None, split="training",
                 mask_type="orb", seed=None):
        super().__init__(aug_params, seed=seed)
        images = sorted(glob(osp.join(root, "data/*.ppm")))
        flows = sorted(glob(osp.join(root, "data/*.flo")))
        masks = sorted(glob(osp.join(mask_root, mask_type, "*.png")))
        assert len(images) == len(masks), (len(images), len(masks))
        assert len(images) // 2 == len(flows)

        split_ids = np.loadtxt(osp.join(root, "FlyingChairs_train_val.txt"), dtype=np.int32)
        want = 1 if split == "training" else 2
        for i in range(len(flows)):
            if split_ids[i] == want:
                self.flow_list.append(flows[i])
                self.image_list.append([images[2 * i], images[2 * i + 1]])
                self.mask_list.append([masks[2 * i], masks[2 * i + 1]])


class FlyingThings3D(FlowDataset):
    def __init__(self, root, mask_root, aug_params=None,
                 dstype="frames_cleanpass", mask_type="orb", seed=None):
        super().__init__(aug_params, seed=seed)
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted([osp.join(d, cam) for d in image_dirs])
                mask_dirs = sorted(glob(osp.join(mask_root, mask_type, dstype, "TRAIN/*/*")))
                mask_dirs = sorted([osp.join(d, cam) for d in mask_dirs])
                flow_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted([osp.join(d, direction, cam) for d in flow_dirs])

                for idir, fdir, mdir in zip(image_dirs, flow_dirs, mask_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    masks = sorted(glob(osp.join(mdir, "*.png")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list.append([images[i], images[i + 1]])
                            self.mask_list.append([masks[i], masks[i + 1]])
                            self.flow_list.append(flows[i])
                        else:
                            self.image_list.append([images[i + 1], images[i]])
                            self.mask_list.append([masks[i + 1], masks[i]])
                            self.flow_list.append(flows[i + 1])


class KITTI(FlowDataset):
    def __init__(self, root, mask_root, aug_params=None, split="training",
                 mask_type="orb", seed=None):
        super().__init__(aug_params, sparse=True, seed=seed)
        if split == "testing":
            self.is_test = True
        image_root = osp.join(root, split)
        mask_root = osp.join(mask_root, mask_type, split)
        images1 = sorted(glob(osp.join(image_root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(image_root, "image_2/*_11.png")))
        masks1 = sorted(glob(osp.join(mask_root, "*_10.png")))
        masks2 = sorted(glob(osp.join(mask_root, "*_11.png")))

        for img1, img2, m1, m2 in zip(images1, images2, masks1, masks2):
            self.extra_info.append([osp.basename(img1)])
            self.image_list.append([img1, img2])
            self.mask_list.append([m1, m2])
        self.flow_list = sorted(glob(osp.join(image_root, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    def __init__(self, root, aug_params=None, seed=None):
        super().__init__(aug_params, sparse=True, seed=seed)
        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(root, "hd1k_flow_gt", "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(root, "hd1k_input", "image_2/%06d_*.png" % seq_ix)))
            if len(flows) == 0:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append([images[i], images[i + 1]])
                # HD1K carries no keypoint masks in the reference; mirror that.
                self.mask_list.append([images[i], images[i + 1]])
            seq_ix += 1


class OminiFlow(FlowDataset):
    """Panoramic scenes; as in the reference, the images stand in for the
    masks."""

    def __init__(self, root, aug_params=None, seed=None):
        super().__init__(aug_params, seed=seed)
        for scene in ("CartoonTree", "Forest", "lowPolyModels"):
            for split in ("0", "1"):
                image_root = osp.join(root, scene)
                image_root = osp.join(
                    image_root, scene if split == "0" else f"{scene}_{split}"
                )
                images = sorted(glob(osp.join(image_root, "images/*.png")))
                flows = sorted(glob(osp.join(image_root, "ground_truth/*.flo")))
                for i in range(len(images) - 1):
                    self.image_list.append([images[i], images[i + 1]])
                    self.flow_list.append(flows[i])
                    self.mask_list.append([images[i], images[i + 1]])


class WeightedConcat:
    """Oversampled dataset union via index arithmetic.

    `WeightedConcat([(ds_a, 100), (ds_b, 1)])` behaves like the reference's
    `100 * ds_a + ds_b` without copying path lists 100x.
    """

    def __init__(self, parts: Sequence):
        self.parts = [(ds, int(w)) for ds, w in parts]
        self._sizes = [len(ds) * w for ds, w in self.parts]
        self._offsets = np.cumsum([0] + self._sizes)

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index: int):
        index = index % len(self)
        part = int(np.searchsorted(self._offsets, index, side="right") - 1)
        ds, _ = self.parts[part]
        return ds[(index - self._offsets[part]) % len(ds)]


class RecipeTagged:
    """Raw-sample wrapper for on-device augmentation: adds the per-sample
    `recipe` index, the row of the recipe table that a stage's mix attaches
    and the device augmentation dispatches on."""

    def __init__(self, dataset, recipe_id: int):
        self.dataset = dataset
        self.recipe_id = recipe_id

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        s = self.dataset[index]
        s["recipe"] = np.int32(self.recipe_id)
        return s


def fetch_dataset(data_root: Dict[str, str], mask_root: Dict[str, str], *,
                  stage: str, image_size, mask_type: str = "orb",
                  train_ds: Optional[str] = "C+T+S", seed: Optional[int] = 0,
                  no_aug: bool = False):
    """The training set of a stage of the curriculum, with the host
    augmentation recipe of each of its datasets (crop to `image_size`,
    scale range, flips): chairs; things (clean + final passes); sintel
    (`train_ds` None: Sintel clean + final; 'C+T+S': 100 x each Sintel
    pass + Things clean; 'C+T+S+K': also 200 x KITTI, sparse); kitti (100 x
    each Sintel pass + 200 x KITTI).

    `no_aug=True` gives raw full-size samples for the on-card augmentation
    (`data/device_aug.py`): every sample tagged with its dataset's row of
    the stage's recipe table (`RecipeTagged`), the table as the result's
    `device_recipes`: one dense row, and for the stages with KITTI a
    sparse one."""
    from .device_aug import dense_recipe, sparse_recipe

    aug = lambda lo, hi: None if no_aug else dict(crop_size=image_size, min_scale=lo,
                                                  max_scale=hi, do_flip=True)
    things = lambda lo, hi, p: FlyingThings3D(data_root["things"], mask_root["things"],
                                               aug(lo, hi), dstype=f"frames_{p}pass",
                                               mask_type=mask_type, seed=seed)
    if stage == "chairs":
        ds = FlyingChairs(data_root["chairs"], mask_root["chairs"], aug(-0.1, 1.0),
                          split="training", mask_type=mask_type, seed=seed)
        if not no_aug:
            return ds
        ds = RecipeTagged(ds, 0)
        ds.device_recipes = [dense_recipe(-0.1, 1.0)]
        return ds
    # (dataset, weight, recipe row)
    if stage == "things":
        parts = [(things(-0.4, 0.8, p), 1, 0) for p in ("clean", "final")]
        recipes = [dense_recipe(-0.4, 0.8)]
    elif stage in ("sintel", "kitti"):
        clean, final = (MpiSintel(data_root["sintel"], mask_root["sintel"], aug(-0.2, 0.6),
                                  dstype=t, mask_type=mask_type, seed=seed)
                        for t in ("clean", "final"))
        recipes = [dense_recipe(-0.2, 0.6)]
        kitti = lambda: (KITTI(data_root["kitti"], mask_root["kitti"], aug(-0.3, 0.5),
                               split="training", mask_type=mask_type, seed=seed), 200, 1)
        sintel = [(clean, 100, 0), (final, 100, 0)]
        if stage == "kitti":
            parts = sintel + [kitti()]
        elif train_ds is None:
            parts = [(clean, 1, 0), (final, 1, 0)]
        elif train_ds == "C+T+S":
            parts = sintel + [(things(-0.2, 0.6, "clean"), 1, 0)]
        elif train_ds == "C+T+S+K":
            parts = [(things(-0.2, 0.6, "clean"), 1, 0)] + sintel + [kitti()]
        else:
            raise ValueError(train_ds)
        if any(r == 1 for _, _, r in parts):
            recipes.append(sparse_recipe(-0.3, 0.5))
    else:
        raise NotImplementedError(f"Stage {stage} not supported.")
    if not no_aug:
        return WeightedConcat([(d, w) for d, w, _ in parts])
    ds = WeightedConcat([(RecipeTagged(d, r), w) for d, w, r in parts])
    ds.device_recipes = recipes
    return ds
