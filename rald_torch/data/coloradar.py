"""ColoRadar dataset: split indexing + per-frame sample assembly; the port's
own copy of ``rald_tpu/data/coloradar.py:38-366``, item for item the same
arrays as the JAX package's dataset on the same tree and seed, but for one
repair: with ``cache_voxel: false`` it voxelizes with the configured voxel
size in float64, as the voxel caches are written, where JAX rounds it to
float32 first (ROADMAP C8), so a cached item equals the live one.

Capability parity with reference
``datasets/aligned_coloradar/Coloradar_dataset.py`` (:19-524): identical
on-disk layout (split JSON, ``lidar_sc``/``lidar_cc`` dirs,
``single_chip/radarcube_raw`` cubes, ``{cone,voxel}_{sc,cc}_*`` voxel caches,
``radar_cfar_low_thrd`` CFAR helper points, latent caches), identical
per-frame processing order (shuffle -> view-cone polar transform -> voxelize ->
surface sampling -> query sampling -> normalization -> radar conditioning).

Design notes (as in the JAX package):
- plain Python class returning numpy dicts (no torch Dataset); batching
  lives in :mod:`rald_torch.data.loader`, device placement in the engine;
- RNG is an explicit per-(epoch, index) ``np.random.Generator`` stream instead
  of the reference's fresh ``default_rng()`` per call — reproducible
  pipelines, same distributions;
- every model-facing array has a fixed shape; ragged host-only arrays (raw
  lidar for metrics) are returned under ``raw_*`` keys.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from rald_torch import geometry as geo
from rald_torch.data.bucket import DEFAULT_EVAL_BUCKETS, pad_axis0, pick_bucket
from rald_torch.data.query import aug_query_helper, sample_eval_queries, sample_train_queries
from rald_torch.data.radar_proc import process_radar_cube
from rald_torch.data.voxelizer import grid_size_of
from rald_torch.native import voxelize  # C++ when built, numpy otherwise


class ColoRadarDataset:
    LIDAR_DIR = {"scRadar": "lidar_sc", "ccRadar": "lidar_cc"}
    RADAR_DIR = {"scRadar": "single_chip/radarcube_raw", "ccRadar": "cascade/radarcube_raw"}
    HELPER_DIR = {"scRadar": "single_chip/radar_cfar_low_thrd", "ccRadar": "cascade/radar_cfar_low_thrd"}

    def __init__(self, root_dir, config, radar_type: str = "scRadar", loader_type: str = "train", seed: int = 0):
        assert loader_type in ("train", "val", "test"), f"Invalid loader type {loader_type}"
        assert radar_type in ("scRadar", "ccRadar"), f"Invalid radar type {radar_type}"
        self.root_dir = Path(root_dir)
        self.config = config
        self.radar_type = radar_type
        self.loader_type = loader_type
        self.seed = seed
        self.epoch = 0

        self.shuffle_pts = config.lidar.get("shuffle_pts", False)
        self.load_query = True
        self.load_radar = True

        self.use_cache_latent = config.get("use_cache_latent", False)
        if self.use_cache_latent:
            self.cache_latent_dir = Path(config.cache_latent_base_dir) / Path(config.cache_latent_sub_dir)
            assert self.cache_latent_dir.exists(), f"Cache latent dir {self.cache_latent_dir} does not exist"

        self.use_pred_latent = config.get("use_pred_latent", False) and loader_type == "test"
        if self.use_pred_latent:
            self.pred_latent_dir = Path(config.pred_latent_base_dir) / Path(config.pred_latent_sub_dir)
            assert self.pred_latent_dir.exists(), f"Pred latent dir {self.pred_latent_dir} does not exist"

        self.use_query_helper = config.get("use_query_helper", False) and loader_type == "test"
        if self.use_query_helper:
            self.query_helper_aug = config.get("query_helper_aug", False)
            self.query_aug_num = int(float(config.get("query_aug_num", 0)))
            self.query_aug_scale = int(config.get("query_aug_scale", 2))
            # ship RAW CFAR points (bucket-padded + mask) and let the engine
            # densify them to query_aug_num (on the device in its fused
            # step, on the host in its modular one): the densified set is
            # ~1e3x larger than the raw one
            self.helper_aug_on_device = bool(config.get("helper_aug_on_device", False))

        # lidar config (reference: Coloradar_dataset.py:49-66)
        lidar = config.lidar
        self.norm_isotropy = lidar.norm_isotropy
        self.norm_anisotropy = lidar.norm_anisotropy
        self.query_ratio = lidar.query_ratio
        self.pc_range = np.array(lidar.pc_range, dtype=np.float32)
        self.num_point_features = lidar.num_point_features
        self.sampling = lidar.sampling
        self.num_samples = lidar.num_samples
        self.voxel_size = np.array(lidar.voxel_size, dtype=np.float32)
        self.grid_size = grid_size_of(self.pc_range, self.voxel_size)
        # the voxelizer gets the configured values in float64, as dump_voxel
        # gives them: float32's 0.05 puts a point on a voxel boundary (a range
        # of exactly 10.5 m) one cell below the one its cache holds (ROADMAP C8)
        self.voxelize_args = (np.asarray(lidar.voxel_size, np.float64),
                              np.asarray(lidar.pc_range, np.float64))
        self.max_points_per_voxel = lidar.max_points_per_voxel
        self.max_voxels = lidar.max_number_of_voxels
        self.view_cone_mode = lidar.get("view_cone_mode", False)
        self.cache_voxel = lidar.cache_voxel
        # ragged-eval bucket ladder (sampling: false pads raw per-frame
        # counts to <=len(buckets) static sizes)
        self.eval_pad_buckets = tuple(
            int(b) for b in lidar.get("eval_pad_buckets", DEFAULT_EVAL_BUCKETS)
        )

        self.load_split()

    # ------------------------------------------------------------------ index

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.epoch, index])

    def _glob_sorted(self, directory: Path, pattern: str, key=None):
        files = list(directory.glob(pattern))
        files.sort(key=key)
        return files

    def _lidar_dir_name(self) -> str:
        return self.LIDAR_DIR[self.radar_type]

    def _radar_dir_name(self) -> str:
        return self.RADAR_DIR[self.radar_type]

    def _build_radar_list(self):
        self.radar_path_list = []
        for seq in self.seq_list:
            self.radar_path_list.extend(
                self._glob_sorted(self.root_dir / seq / self._radar_dir_name(), "*.bin")
            )

    def load_split(self):
        """Serialize per-sequence file lists (reference: Coloradar_dataset.py:140-226)."""
        split_file = self.root_dir / self.config.split_file
        with open(split_file, "r") as f:
            self.split = json.load(f)
        self.seq_list = self.split[self.loader_type]

        lidar_dir_name = self._lidar_dir_name()
        radar_dir_name = self._radar_dir_name()
        for seq in self.seq_list:
            assert (self.root_dir / seq / lidar_dir_name).exists(), f"{self.root_dir / seq / lidar_dir_name} missing"
            assert (self.root_dir / seq / radar_dir_name).exists(), f"{self.root_dir / seq / radar_dir_name} missing"

        self.index_dict = {}
        total = 0
        self.lidar_path_list = []
        for seq in self.seq_list:
            files = self._glob_sorted(self.root_dir / seq / lidar_dir_name, "*.bin")
            self.index_dict[seq] = (total, total + len(files))
            total += len(files)
            self.lidar_path_list.extend(files)

        if self.cache_voxel:
            type_name = "sc" if self.radar_type == "scRadar" else "cc"
            voxel_type = "cone" if self.view_cone_mode else "voxel"
            vs = self.voxel_size
            vdir = f"{voxel_type}_{type_name}_{round(float(vs[0]), 2)}_{round(float(vs[1]), 2)}_{round(float(vs[2]), 2)}"
            self.lidar_voxel_path_list = []
            for seq in self.seq_list:
                d = self.root_dir / seq / vdir
                assert d.exists(), f"{d} missing"
                self.lidar_voxel_path_list.extend(self._glob_sorted(d, "*.npy"))
            assert len(self.lidar_voxel_path_list) == len(self.lidar_path_list)

        if self.load_radar:
            self._build_radar_list()
            assert len(self.radar_path_list) == len(self.lidar_path_list)

        if self.use_cache_latent:
            self.cache_latent_path_list = []
            for seq in self.seq_list:
                self.cache_latent_path_list.extend(self._glob_sorted(self.cache_latent_dir / seq, "*.npz"))
            assert len(self.cache_latent_path_list) == len(self.lidar_path_list)

        if self.use_pred_latent:
            self.pred_latent_path_list = []
            for seq in self.seq_list:
                d = self.pred_latent_dir / seq / "latent_tokens"
                files = self._glob_sorted(d, "*.np[yz]") + self._glob_sorted(d, "*.pt")
                files.sort()
                self.pred_latent_path_list.extend(files)
            assert len(self.pred_latent_path_list) == len(self.lidar_path_list)

        if self.use_query_helper:
            helper_dir = self.HELPER_DIR[self.radar_type]
            self.cfar_query_helper_path_list = []
            for seq in self.seq_list:
                self.cfar_query_helper_path_list.extend(
                    self._glob_sorted(self.root_dir / seq / helper_dir, "*.bin")
                )
            assert len(self.cfar_query_helper_path_list) == len(self.lidar_path_list)

    def __len__(self):
        return len(self.lidar_path_list)

    # ------------------------------------------------------------------ loads

    def load_lidar(self, idx):
        path = self.lidar_path_list[idx]
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, self.num_point_features)
        return pts, path

    def load_radarcube(self, idx):
        path = self.radar_path_list[idx]
        r = self.config.radar
        cube = np.fromfile(path, dtype=np.float32).reshape(r.input_r_dim, r.input_a_dim, r.input_e_dim, -1)
        return cube, path

    def load_cached_latent(self, idx):
        path = self.cache_latent_path_list[idx]
        return np.load(path, allow_pickle=True)["res_tokens"], path

    def load_pred_latent(self, idx):
        path = self.pred_latent_path_list[idx]
        if path.suffix == ".pt":
            return torch.load(path, weights_only=True).numpy(), path
        return np.load(path), path

    def load_helper_point(self, idx, rng):
        path = self.cfar_query_helper_path_list[idx]
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, self.num_point_features)
        if self.query_helper_aug and not self.helper_aug_on_device:
            pts = aug_query_helper(
                pts, self.query_aug_num, self.pc_range, self.voxel_size,
                self.query_aug_scale, rng,
            )
        return pts, path

    # ------------------------------------------------------------------ item

    def _get_voxels(self, points, idx):
        if self.cache_voxel:
            d = np.load(self.lidar_voxel_path_list[idx], allow_pickle=True).item()
            return d["voxels"], d["voxel_coords"], d["voxel_num_points"]
        grid = voxelize(points, *self.voxelize_args, self.max_points_per_voxel, self.max_voxels)
        return grid.voxels, grid.coords, grid.num_points

    def _norm(self, pts):
        return geo.norm_points(
            pts, self.pc_range, anisotropic=self.norm_anisotropy, isotropic=self.norm_isotropy
        ).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        rng = self._rng(index)
        data = {}

        points, lidar_path = self.load_lidar(index)
        points = points[:, :3]
        if self.loader_type != "train":
            data["raw_lidar_points"] = points.copy()
        if self.shuffle_pts:
            points = points[rng.permutation(points.shape[0])]
        data["lidar_path"] = str(lidar_path)
        if self.view_cone_mode:
            points = geo.cartesian2polar(points).astype(np.float32)

        voxels, coords_zyx, _num = self._get_voxels(points, index)
        coords_zyx = np.asarray(coords_zyx)

        if self.sampling:
            # replace=True only when the frame is short of points — the
            # reference crashes there (Coloradar_dataset.py:91-97)
            n = points.shape[0]
            pick = rng.choice(n, self.num_samples, replace=n < self.num_samples)
            points = points[pick]

        bucket = None
        if not self.sampling:
            # raw per-frame counts (reference eval configs, sampling: false):
            # bucket-pad to few static sizes
            bucket = pick_bucket(points.shape[0], self.eval_pad_buckets)
            if points.shape[0] > bucket:  # beyond the largest bucket: subsample
                points = points[rng.choice(points.shape[0], bucket, replace=False)]

        points_num = points.shape[0]
        in_num = int(points_num * self.query_ratio)
        out_num = points_num - in_num

        if bucket is None:
            data["lidar_points"] = self._norm(points[:, :3])
        else:
            padded, mask = pad_axis0(self._norm(points[:, :3]), bucket)
            data["lidar_points"] = padded
            data["lidar_mask"] = mask
            data["points_num"] = np.int32(points_num)

        if self.load_query:
            if self.loader_type == "train":
                q, l = sample_train_queries(
                    coords_zyx, self.grid_size, self.voxel_size, self.pc_range,
                    in_num, out_num, rng,
                )
            else:
                q, l = sample_eval_queries(coords_zyx, self.voxel_size, self.pc_range, points_num, rng)
            if bucket is None:
                data["query_points"] = self._norm(q)
                data["query_labels"] = l
            else:
                qp, qmask = pad_axis0(self._norm(q), bucket)
                ql, _ = pad_axis0(l, bucket)
                data["query_points"] = qp
                data["query_labels"] = ql
                data["query_mask"] = qmask
            data["in_voxel_num"] = np.int32(in_num)

        if self.use_query_helper:
            helper, helper_path = self.load_helper_point(index, rng)
            if self.query_helper_aug and self.helper_aug_on_device:
                # raw CFAR points, pow2-bucket-padded: the engine densifies
                # them to query_aug_num (helper_mask marks real rows)
                cap = max(1024, 1 << (max(len(helper), 1) - 1).bit_length())
                cap = min(cap, self.query_aug_num) if self.query_aug_num else cap
                padded, mask = pad_axis0(self._norm(helper[:, :3]), cap)
                data["helper_points"] = padded.astype(np.float32)
                data["helper_mask"] = mask.astype(bool)
            else:
                data["helper_points"] = self._norm(helper[:, :3])
            data["helper_point_path"] = str(helper_path)

        if self.load_radar:
            cube, radar_path = self.load_radarcube(index)
            r = self.config.radar
            # with upsample_on_device the raw-size cube ships to the card
            # (32x less transfer) and the engine resizes it there
            data["radar_cube"] = process_radar_cube(
                cube,
                norm_intensity=r.norm_intensity,
                max_intensity=r.max_intensity,
                norm_dopp=r.norm_dopp,
                max_dopp=r.max_dopp,
                upsample=r.get("upsample", False) and not r.get("upsample_on_device", False),
                tgt_a=r.get("tgt_a_dim"),
                tgt_e=r.get("tgt_e_dim"),
            )
            data["radar_path"] = str(radar_path)

        if self.use_cache_latent:
            latent, latent_path = self.load_cached_latent(index)
            data["cache_latent"] = latent
            data["cache_latent_path"] = str(latent_path)
            assert Path(lidar_path).name == Path(latent_path).stem, (
                f"Cache latent {latent_path} does not match lidar {lidar_path}"
            )

        if self.use_pred_latent:
            latent, latent_path = self.load_pred_latent(index)
            data["pred_latent"] = latent
            data["pred_latent_path"] = str(latent_path)

        return data

    # toggles (reference: Coloradar_dataset.py:517-524)
    def set_load_query(self, v: bool):
        self.load_query = v

    def set_load_radar(self, v: bool):
        self.load_radar = v

    def set_load_latent(self, v: bool):
        self.use_cache_latent = v
