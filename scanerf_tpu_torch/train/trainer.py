"""End-to-end training of a city's tiles (counterpart of
``scanerf_tpu/train/trainer.py``).

The JAX package runs its tiles as one SPMD program over a device mesh;
the port runs one process per rank (``torch.distributed``, joined before
the ``Trainer`` is built, e.g. by ``torchrun``) over the mesh
``tile_parallel.make_tile_mesh`` builds from the world size and the
config's TABLE_SHARDS and RAY_SHARDS. The tile count is padded to a
multiple of the ``tiles`` axis with copies of the last tile whose
``cam_map`` row is all -1 (trained, but neither counted in the consensus
nor exported). Each rank keeps its tiles' states in a list, and each
sync round trains them one after another, then takes one ADMM consensus
over the tiles of every rank (``tile_parallel.build_admm_round``). With
RHO > 0 a round is SYN_ITERS steps and the consensus couples the tiles'
shared cameras; with RHO 0 the tiles train independently in rounds of at
most MAX_ROUND_STEPS (and EVAL_STEP). One process is a mesh of one rank.

Host-side duties between rounds, as in the JAX trainer:
- occupancy pruning on the GRID_LOG2DIM ladder (``models/occupancy.py``),
- the cross-tile occlusion-mask refresh every UPDATE_MASK_STEP,
- eval renders with PSNR / SSIM and pose snapshots every EVAL_STEP,
- checkpoints every CKPT_STEP, and at the end per-tile exports and
  ``refined_camera.log``.

Before the first round each tile gets its first occupancy grid and its
occlusion masks from the proxy mesh (``geometry/mesh_engine.py``), in BS
mode its background depths, and cameras padded to the largest tile's
count (padded cameras are fully occluded). The trainer's device defaults
to "cuda" (the rank's card, LOCAL_RANK modulo the cards) and raises
without CUDA; ``device="cpu"`` runs the plain path.

Across ranks the duties need whole tables: pruning, the occlusion
refresh, evals, checkpoints and exports gather a sharded tile's table
(and, for checkpoints, its moments) one tile at a time; every rank of a
tile renders what the refresh publishes, the published depths are
exchanged over the ``tiles`` axis (the last tile in order wins a
camera, as in one process), and the rank at index 0 of the ``rays`` and
``table`` axes writes a tile's files. Rank 0 writes ``training.log``,
``admm_error.txt`` and ``refined_camera.log``. Checkpoints and exports
keep the JAX package's layout whatever the mesh.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from datetime import datetime

import numpy as np
import torch

from scanerf_tpu_torch import _device
from scanerf_tpu_torch.data import io as data_io
from scanerf_tpu_torch.data.png import write_png
from scanerf_tpu_torch.geometry.mesh_engine import ProxyMesh
from scanerf_tpu_torch.models import field as field_lib
from scanerf_tpu_torch.models import occupancy as occupancy_lib
from scanerf_tpu_torch.ops.hash_encode import table_rows
from scanerf_tpu_torch.ops.intersect import ray_aabb
from scanerf_tpu_torch.parallel import mesh as mesh_lib
from scanerf_tpu_torch.parallel import table_parallel
from scanerf_tpu_torch.parallel import tile_parallel as tp
from scanerf_tpu_torch.train import cameras as cam_lib
from scanerf_tpu_torch.train import checkpoint as ckpt_lib
from scanerf_tpu_torch.train import tile as tile_lib
from scanerf_tpu_torch.train.tile import TileData, TrainConfig
from scanerf_tpu_torch.utils import lie, metrics
from scanerf_tpu_torch.utils import rays as rays_mod


def read_block_idx_file(path: str) -> dict[int, list[int]]:
    """blocks/test.txt / novel.txt: "tile v0 v1 ..." lines."""
    out: dict[int, list[int]] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if parts[0]:
                out[int(parts[0])] = [int(x) for x in parts[1:]]
    return out


def dilate(mask: np.ndarray, size: int) -> np.ndarray:
    """Binary dilation of a uint8 [H, W] mask by a size x size box, pixels
    outside the image ignored (``cv2.dilate`` with its default border):
    a box's maximum is the maximum over its columns of each row's, so two
    1-D passes."""
    t = torch.from_numpy(mask.astype(np.float32))[None, None]
    t = torch.nn.functional.max_pool2d(t, (size, 1), stride=1, padding=(size // 2, 0))
    t = torch.nn.functional.max_pool2d(t, (1, size), stride=1, padding=(0, size // 2))
    return t[0, 0].numpy().astype(np.uint8)


class Trainer:
    def __init__(self, cfg, device="cuda", backend: str | None = None):
        """``backend``: the mesh groups' collective backend (default: the
        joined group's); one process needs none."""
        self.device = _device.resolve(mesh_lib.local_device(device))
        self.cfg = cfg
        self.tc = TrainConfig.from_cfg(cfg)
        self.mesh = tp.make_tile_mesh(self.tc.table_shards, self.tc.ray_shards, backend)
        self.rank = mesh_lib.world()[0]
        # this rank writes its tiles' files: index 0 of the rays and table axes
        self.writer = self.mesh.index("rays") == 0 and self.mesh.index("table") == 0
        self.datadir = cfg.DATADIR
        self.tile_idxs: list[int] = list(cfg.TILES)

        if self.rank == 0:
            runtime = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            prefix = f"{cfg.PREFIX}-{runtime}" if cfg.PREFIX else runtime
            self.logdir = os.path.join(self.datadir, "logs", prefix)
            # two Trainers in the same second must not share a logdir
            n = 0
            while os.path.exists(self.logdir):
                n += 1
                self.logdir = os.path.join(self.datadir, "logs", f"{prefix}.{n}")
            os.makedirs(self.logdir)
        self.logdir = mesh_lib.broadcast_object(self.logdir if self.rank == 0 else None)

        self.ks_all, self.c2ws_all, self.H, self.W = data_io.read_campara(
            os.path.join(self.datadir, "camera.log"), return_shape=True)
        self.num_global_cams = self.ks_all.shape[0]
        self.tile_infos = data_io.read_tile_info(
            os.path.join(self.datadir, "tiles", "tile_info.txt"))
        self.training_views = data_io.read_training_views(
            os.path.join(self.datadir, "tiles", "training_views.txt"))
        self.test_idxs = read_block_idx_file(os.path.join(self.datadir, "blocks", "test.txt"))

        mesh_path = os.path.join(self.datadir, "mesh", "mesh.ply")
        self.fmesh = ProxyMesh(mesh_path) if os.path.exists(mesh_path) else None

        # pose noise table over all cameras
        rng = np.random.RandomState(cfg.SEED)
        self.noise_table = float(cfg.TRAINING.CAMOPT.NOISE) * rng.randn(
            self.num_global_cams, 6).astype(np.float32)
        try:
            _, self.gt_c2ws = data_io.read_campara(os.path.join(self.datadir, "camera-gt.log"))
        except FileNotFoundError:
            self.gt_c2ws = None

        self.pruning = occupancy_lib.PruningSchedule(
            list(cfg.TRAINING.GRID_LOG2DIM), list(cfg.TRAINING.PRUNING_TH),
            cfg.TRAINING.ADJUST_STEP, total_step=cfg.TRAINING.TOTAL_STEP)
        self._build_tiles()

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _views_for(self, tile_idx: int) -> list[int]:
        """Visible views: the MAX_POSES cap, then the test views."""
        views = list(dict.fromkeys(self.training_views[tile_idx]))[:self.cfg.MAX_POSES]
        return list(dict.fromkeys(views + self.test_idxs.get(tile_idx, [])))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _build_one_tile(self, tile_idx: int, max_cams: int):
        info = self.tile_infos[tile_idx]
        scene = data_io.load_scene(
            self.datadir, self._views_for(tile_idx),
            mono_depth=self.tc.w_depth > 0 or self.tc.w_smooth > 0,
            mono_normal=self.tc.w_smooth > 0)
        views = scene.idx_list
        H, W = scene.H, scene.W

        # the first occupancy grid: the proxy mesh voxelized over the inner bbox
        center = info.corner + info.size / 2.0
        size2 = info.size * 2.0
        min_bbox = center - size2 / 2.0
        log2 = int(self.cfg.TRAINING.GRID_LOG2DIM[0])
        occ = None
        if self.fmesh is not None:
            occ, _ = self.fmesh.voxelize(np.array([log2] * 3), min_bbox + size2 / 4.0,
                                         size2 / 2.0, init_outside=info.init_outside)
        params, fstate = field_lib.create_field(
            torch.Generator(device=self.device).manual_seed(self.cfg.SEED + tile_idx),
            info.corner, info.size, log2_hashmap_size=self.cfg.HASHGRID.LOG2_HASHMAP_SIZE,
            grid_resolution=info.resolution, sampler_log2dim=log2, occupied_grid=occ,
            cubic_grid=True, device=self.device)

        gt = self.gt_c2ws[views] if self.gt_c2ws is not None else None
        cams_cpu = cam_lib.make_cameras(
            torch.from_numpy(scene.ks), torch.from_numpy(scene.c2ws),
            noise_se3=torch.from_numpy(self.noise_table[views]),
            gt_c2ws=torch.from_numpy(gt) if gt is not None else None)

        def all_rays(i):
            o, d = rays_mod.get_all_rays(H, W, cams_cpu.rts[i], cams_cpu.ks[i])
            return o.numpy(), d.numpy()

        occl = np.ones((len(views), H, W), bool)
        bg_depths = None
        if self.fmesh is not None:
            self.fmesh.set(center, info.size / 2.0)
            for i in range(len(views)):
                occl[i] = self.fmesh.render_mask(*all_rays(i)).reshape(H, W)
            if self.cfg.TRAINING.BG_MODE == "BS":
                # the mesh's depth behind the doubled box, per camera
                self.fmesh.set(center, info.size)
                bg_depths = np.zeros((len(views), H, W), np.float32)
                for i in range(len(views)):
                    bg_z, has_bg, _ = self.fmesh.compute_bgdepth_batch(*all_rays(i))
                    bg_depths[i] = np.where(has_bg, bg_z, 0.0).reshape(H, W)
                self.fmesh.set(center, info.size / 2.0)

        zeros_hw = np.zeros((len(views), H, W), np.float32)
        data = TileData(
            images=self._tensor(scene.images), occlusions=self._tensor(occl),
            cameras=cam_lib.Cameras(ks=cams_cpu.ks.to(self.device),
                                    rts=cams_cpu.rts.to(self.device),
                                    gt_rts=cams_cpu.gt_rts.to(self.device)),
            mono_depths=self._tensor(scene.mono_depths if scene.mono_depths is not None
                                     else zeros_hw),
            mono_normals=self._tensor(scene.mono_normals if scene.mono_normals is not None
                                      else np.zeros((len(views), H, W, 3), np.float32)),
            bg_depths=self._tensor(bg_depths) if bg_depths is not None else None)
        data = _pad_data_cams(data, max_cams)
        table_axis = self.mesh.axis("table")
        state = tile_lib.create_train_state(params, fstate, max_cams, self.tc,
                                            device=self.device, table_axis=table_axis)

        # resume: an explicit CKP directory, else the datadir
        ckp_dir = str(self.cfg.get("CKP", "") or "") or self.datadir
        ckp = ckpt_lib.latest_checkpoint(ckp_dir, tile_idx)
        if ckp:
            state = ckpt_lib.load_checkpoint(ckp, state, device=self.device)
            if table_axis is not None:  # a checkpoint holds whole tables
                state = table_parallel.shard_state(state, table_axis)
            print(f"tile {tile_idx}: resumed from {ckp}")
        return state, data, views, info

    def _build_tiles(self):
        """This rank's tiles (its slot of the ``tiles`` axis, the count
        padded to a multiple of the axis), and every tile's cam map."""
        max_cams = max(len(self._views_for(t)) for t in self.tile_idxs)
        n_pad = -(-len(self.tile_idxs) // self.mesh.size("tiles")) * self.mesh.size("tiles")
        self.local_ids = tp.local_tiles(self.mesh, n_pad)  # indices into the padded list
        # a padded slot holds a copy of the last tile
        tiles = [self.tile_idxs[min(j, len(self.tile_idxs) - 1)] for j in self.local_ids]
        self.states, self.datas, self.infos, self.view_lists = [], [], [], []
        rows = np.zeros((n_pad, max_cams), np.int32)  # cam ids + 1, 0 = none
        for j, t in zip(self.local_ids, tiles):
            state, data, views, info = self._build_one_tile(t, max_cams)
            self.states.append(state)
            self.datas.append(data)
            self.infos.append(info)
            self.view_lists.append(views)  # after ignore.log filtering
            if j < len(self.tile_idxs):
                rows[j, :len(views[:max_cams])] = np.asarray(views[:max_cams]) + 1
        # every tile's cam map: each tile's row from its slot of the tiles axis
        rows_t = mesh_lib.all_reduce(torch.from_numpy(rows).to(self.device),
                                     self.mesh.axis("tiles"))
        self.cam_maps = rows_t.cpu().numpy().astype(np.int32) - 1  # [T_pad, M], -1 padding
        self.cam_map = torch.from_numpy(self.cam_maps[self.local_ids]).to(self.device)
        self.confidence = torch.ones(self.cam_map.shape, device=self.device)
        self.generators = [tile_lib.batch_generator(self.cfg.SEED, self.mesh, t)
                           for t in tiles]
        self.round_fn = {}  # the round of each size, built at its first use

    def _real(self):
        """(state, data, info, views, tile id) of this rank's real tiles (not
        the padding)."""
        return [(s, d, i, v, self.tile_idxs[j]) for s, d, i, v, j in
                zip(self.states, self.datas, self.infos, self.view_lists, self.local_ids)
                if j < len(self.tile_idxs)]

    def _whole(self, state):
        """``state`` with its whole table (a gather over the ``table``
        axis, which every rank of the tile calls)."""
        return table_parallel.gather_state(state, self.mesh.axis("table"))

    @property
    def _tc_whole(self) -> TrainConfig:
        """The config for renders of gathered (whole) tables."""
        return dataclasses.replace(self.tc, table_shards=1, ray_shards=1)

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def round_size(self) -> int:
        """Steps a round: SYN_ITERS with ADMM; else the eval cadence,
        capped at MAX_ROUND_STEPS and TOTAL_STEP."""
        if self.cfg.RHO > 0:
            return int(self.cfg.SYN_ITERS)
        eval_step = int(self.cfg.get("EVAL_STEP", 1000))
        round_cap = int(self.cfg.get("MAX_ROUND_STEPS", 100))
        return max(min(self.tc.total_step, eval_step, round_cap), 1)

    def run(self):
        """Rounds until TOTAL_STEP, then the exports."""
        while self.states[0].step < self.tc.total_step:
            self.train_round()
        self._export()
        return self.states

    def train_round(self):
        """One round and the duties after it -> the consensus aux."""
        cfg = self.cfg
        syn = self.round_size()
        t0 = time.time()
        if syn not in self.round_fn:
            self.round_fn[syn] = tp.build_admm_round(self.mesh, self.tc, syn,
                                                     self.num_global_cams)
        tiles = tp.ParallelTiles(self.states, self.cam_map, self.confidence, self.local_ids)
        local, aux = self.round_fn[syn](tiles, self.datas, self.generators)
        # every tile's last loss, from its slot of the tiles axis
        losses = torch.zeros(len(self.cam_maps), device=self.device)
        losses[self.local_ids] = local.detach().to(torch.float32)
        losses = mesh_lib.all_reduce(losses, self.mesh.axis("tiles")).cpu().numpy()
        step = self.states[0].step
        dt = time.time() - t0
        if self.rank == 0:
            with open(os.path.join(self.logdir, "training.log"), "a") as f:
                f.write(f"step {step}\tloss {losses[:len(self.tile_idxs)].mean():.6f}\t"
                        f"{dt:.1f}s/round\n")
            if cfg.RHO > 0:
                with open(os.path.join(self.logdir, "admm_error.txt"), "a") as f:
                    f.write(f"primal_residual: {float(aux.primal_residual):.8f}\t"
                            f"dual_residual: {float(aux.dual_residual):.8f}\n")

        if self.pruning.should_prune(step, round_size=syn):
            self._prune(step)
        update_mask_step = int(cfg.get("UPDATE_MASK_STEP", 10000))
        if step % update_mask_step < syn and step >= update_mask_step:
            self._refresh_occlusion_masks()
        eval_step = int(cfg.get("EVAL_STEP", 1000))
        if step % eval_step < syn and step > 0:
            self._eval(step)
        ckpt_step = int(cfg.get("CKPT_STEP", 0))
        if ckpt_step > 0 and step % ckpt_step < syn and step < self.tc.total_step:
            self._save_round_checkpoints(step)
        return aux

    def _save_round_checkpoints(self, step: int):
        """checkpoint-{step}-{tile}.npz for every tile (whole tables); older
        periodic saves of the tile are removed."""
        for s, _, _, _, tile_idx in self._real():
            whole = self._whole(s)
            if not self.writer:
                continue
            path = ckpt_lib.checkpoint_path(self.logdir, step, tile_idx)
            ckpt_lib.save_checkpoint(path, whole)
            for old in glob.glob(os.path.join(self.logdir, f"checkpoint-*-{tile_idx}.npz")):
                if old != path:
                    os.remove(old)

    # ------------------------------------------------------------------

    def _backend(self, state) -> str:
        return field_lib.effective_backend(
            self.tc.hash_backend, table_rows(state.params.field.features) * self.tc.table_shards)

    def _prune(self, step: int):
        """Re-derive every tile's occupancy at the ladder's next rung (each
        rank of a tile prunes its gathered table alike)."""
        sub_split, th = self.pruning.next_at(step)
        for s in self.states:
            finest = s.field_state.resolutions[-1].cpu().numpy()
            whole = self._whole(s)
            s.field_state = occupancy_lib.prune_occupancy(
                whole.params.field, s.field_state, step, finest, sub_split, th,
                backend=self._backend(s))
            del whole
        print(f"step {step}: pruned occupancy (n_split={sub_split}, th={th})")

    def _refresh_occlusion_masks(self) -> int:
        """Cross-tile occlusion-mask refresh. Each tile renders half-size
        depth maps of its cameras whose centre lies inside it and publishes
        them per global camera (the last tile in order wins a camera that
        several publish; across ranks the choice and the maps go over the
        ``tiles`` axis); every other tile holding such a camera keeps a
        pixel trainable only where the published depth lies beyond its own
        box entry, with the untrainable region dilated by a 91-wide box.
        Returns how many depths were published."""
        H, W = self.H, self.W
        tiles_axis = self.mesh.axis("tiles")

        def eye_inside(rt, info):
            center = info.corner + info.size / 2.0
            eye = -rt[:, :3].T @ rt[:, 3]
            return bool(np.all(np.abs(eye - center) < info.size / 2.0))

        rts_all = [cam_lib.get_rts(d.cameras, s.params.se3_refine).detach().cpu().numpy()
                   for s, d in zip(self.states, self.datas)]
        # publish: all qualifying views of a tile in one chunked stream
        published: dict[int, tuple[int, np.ndarray]] = {}
        for s, d, info, views, rts, j in zip(self.states, self.datas, self.infos,
                                             self.view_lists, rts_all, self.local_ids):
            if j >= len(self.tile_idxs):
                continue  # padding publishes nothing
            inside = [(li, gv) for li, gv in enumerate(views) if eye_inside(rts[li], info)]
            if not inside:
                continue
            depths = tile_lib.render_depth_batch(
                self._whole(s), d.cameras, [li for li, _ in inside], H // 2, W // 2,
                dataclasses.replace(self._tc_whole, num_march=min(self.tc.num_march, 256)),
                chunk=2**14, k_scale=((W // 2) / W, (H // 2) / H), device=self.device)
            for k, (_, gv) in enumerate(inside):
                published[gv] = (j, depths[k])
        # each camera's publisher over the ranks, then its map
        pub = torch.full((self.num_global_cams,), -1, dtype=torch.int32, device=self.device)
        for gv, (j, _) in published.items():
            pub[gv] = j
        pub = mesh_lib.all_reduce(pub, tiles_axis, "max").cpu().numpy()
        cams = [int(gv) for gv in np.flatnonzero(pub >= 0)]
        if not cams:
            return 0
        maps = torch.zeros((len(cams), H // 2, W // 2), device=self.device)
        for k, gv in enumerate(cams):
            if gv in published and published[gv][0] == pub[gv]:
                maps[k] = torch.from_numpy(published[gv][1])
        maps = mesh_lib.all_reduce(maps, tiles_axis).cpu().numpy()
        shared_depth = {gv: maps[k] for k, gv in enumerate(cams)}

        for i, (d, info, views, rts) in enumerate(zip(self.datas, self.infos,
                                                      self.view_lists, rts_all)):
            center = info.corner + info.size / 2.0
            occl = d.occlusions.cpu().numpy().copy()
            changed = False
            for li, gv in enumerate(views):
                if gv not in shared_depth or eye_inside(rts[li], info):
                    continue
                o, rd = rays_mod.get_all_rays(H, W, torch.from_numpy(rts[li]),
                                              d.cameras.ks[li].cpu())
                b = ray_aabb(o, rd, torch.from_numpy(center),
                             torch.from_numpy(info.size / 2.0)).numpy()
                up = np.repeat(np.repeat(shared_depth[gv], 2, axis=0), 2, axis=1)
                if up.shape[0] < H or up.shape[1] < W:  # odd native sizes
                    up = np.pad(up, ((0, H - up.shape[0]), (0, W - up.shape[1])),
                                mode="edge")
                depth = up[:H, :W].reshape(-1)
                mask = ((depth > b[:, 0]) & (b[:, 0] != -1)).reshape(H, W).astype(np.uint8)
                occl[li] = (1 - dilate(1 - mask, 91)).astype(bool)
                changed = True
            if changed:
                self.datas[i] = dataclasses.replace(d, occlusions=self._tensor(occl))
        if self.rank == 0:
            print(f"refreshed occlusion masks from {len(shared_depth)} shared depths")
        return len(shared_depth)

    def _eval(self, step: int) -> dict[int, tuple[float, float]]:
        """Eval render of each tile's first test view (its first view
        without one): PSNR / SSIM into training.log with a panel image,
        the pose snapshot, and the pose error against camera-gt.log when
        the scene has one -> {tile: (psnr, ssim)} of the tiles this rank
        writes."""
        out = {}
        log = os.path.join(self.logdir, "training.log")
        for s, d, _, views, tile_idx in self._real():
            whole = self._whole(s)
            if not self.writer:
                continue
            test = self.test_idxs.get(tile_idx, [])
            eval_local = [views.index(v) for v in test if v in views] or [0]
            for li in eval_local[:1]:
                img = tile_lib.render_image(whole, d.cameras, li, self.H, self.W,
                                            self._tc_whole, device=self.device)
                rgb = torch.from_numpy(img["rgb"])
                gt = d.images[li].cpu()
                p, ss = float(metrics.psnr(rgb, gt)), float(metrics.ssim(rgb, gt))
                out[tile_idx] = (p, ss)
                panel = np.concatenate([img["rgb"], gt.numpy()], axis=1)
                write_png(os.path.join(self.logdir, f"eval-tile{tile_idx}-{step}-{p:.2f}-"
                                                    f"{ss:.4f}.png"),
                          (np.clip(panel, 0, 1) * 255).astype(np.uint8))
                with open(log, "a") as f:
                    f.write(f"step {step} tile {tile_idx} eval_psnr {p:.4f} "
                            f"eval_ssim {ss:.6f}\n")
            np.savez(os.path.join(self.logdir, f"cams-tile{tile_idx}-{step}.npz"),
                     se3_refine=s.params.se3_refine.detach().cpu().numpy())
            if self.gt_c2ws is not None:
                n_real = len(views)
                r_deg, t_err = cam_lib.evaluate_camera_alignment(
                    _slice_cams(d.cameras, n_real), s.params.se3_refine[:n_real].detach())
                with open(log, "a") as f:
                    f.write(f"step {step} tile {tile_idx} pose_err "
                            f"R {float(r_deg):.4f}deg t {float(t_err):.6f}\n")
        return out

    def _export(self):
        """Per-tile exports and checkpoints (whole tables), and
        ``refined_camera.log``: each global camera's refinement averaged
        over the tiles holding it (over every rank), composed with the
        known pose noise onto the clean poses."""
        sums = torch.zeros((self.num_global_cams, 7), device=self.device)
        for s, d, _, views, tile_idx in self._real():
            whole = self._whole(s)
            n_real = len(views)
            if self.writer:
                ckpt_lib.export_tile(
                    os.path.join(self.logdir, f"tile-{tile_idx}"),
                    _slice_state_cams(whole, n_real), _slice_cams(d.cameras, n_real), views,
                    hash_layout="windowed" if self._backend(s) == "windowed" else "global")
                ckpt_lib.save_checkpoint(
                    ckpt_lib.checkpoint_path(self.logdir, s.step, tile_idx), whole)
            del whole
            se3 = s.params.se3_refine.detach()[:n_real]
            idx = torch.as_tensor(views, device=self.device)
            sums[:, :6].index_add_(0, idx, se3)
            sums[:, 6].index_add_(0, idx, torch.ones(n_real, device=self.device))
        sums = mesh_lib.all_reduce(sums, self.mesh.axis("tiles")).cpu().numpy()
        if self.rank != 0:
            return
        shared_avg = sums[:, :6] / np.maximum(sums[:, 6], 1)[:, None]
        ori_rts = lie.invert(torch.from_numpy(self.c2ws_all))
        base_rts = lie.compose([lie.se3_to_SE3(torch.from_numpy(self.noise_table)), ori_rts])
        refined_rts = lie.compose([lie.se3_to_SE3(torch.from_numpy(shared_avg)), base_rts])
        data_io.write_campara(os.path.join(self.logdir, "refined_camera.log"), self.ks_all,
                              lie.invert(refined_rts).numpy(), self.H, self.W)
        print(f"exported tiles + refined cameras to {self.logdir}")


# ---------------------------------------------------------------------------
# padding / slicing helpers
# ---------------------------------------------------------------------------

def _pad_data_cams(data: TileData, max_cams: int) -> TileData:
    """Pad the camera axis to ``max_cams``: zero images, fully occluded
    pixels, poses and intrinsics repeated from the last camera."""
    pad = max_cams - data.images.shape[0]
    if pad == 0:
        return data

    def padx(x, identity=False):
        extra = x[-1:].expand(pad, *x.shape[1:]) if identity \
            else torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=x.device)
        return torch.cat([x, extra])

    cams = data.cameras
    return TileData(
        images=padx(data.images), occlusions=padx(data.occlusions),
        cameras=cam_lib.Cameras(ks=padx(cams.ks, True), rts=padx(cams.rts, True),
                                gt_rts=padx(cams.gt_rts, True)),
        mono_depths=padx(data.mono_depths), mono_normals=padx(data.mono_normals),
        bg_depths=padx(data.bg_depths) if data.bg_depths is not None else None)


def _slice_cams(cams, n):
    return cam_lib.Cameras(ks=cams.ks[:n], rts=cams.rts[:n], gt_rts=cams.gt_rts[:n])


def _slice_state_cams(state, n):
    params = dataclasses.replace(state.params, se3_refine=state.params.se3_refine[:n])
    return dataclasses.replace(state, params=params)
