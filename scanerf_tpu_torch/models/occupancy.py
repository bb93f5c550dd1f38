"""Occupancy-grid pruning with progressive subdivision (counterpart of
``scanerf_tpu/models/occupancy.py``).

Every pruning event re-derives a tile's occupancy grid from its live
density field: each occupied cell, split 2x per axis ``sub_split`` times
toward the ladder's next rung, is sampled on a lattice inside the cell
and kept when its largest alpha = 1 - exp(-sigma) exceeds the threshold.
The lattice and the cell list are numpy, as in the JAX package; the
density query is ``field.field_inference_sigma`` in chunks of cells, on
the field's device (the windowed layout through B2 and B3 on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scanerf_tpu_torch.models import field as field_lib
from scanerf_tpu_torch.models.field import FieldParams, FieldState


def query_lattice(occupied_grid: np.ndarray, step: int, finest_resolution,
                  sub_split: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The pruning query's points: the occupied cells of the grid split 2x
    per axis ``sub_split`` times (locs [C, 3]), its shape [3], the cells'
    corners [C, 3] and one cell's lattice [S, 3], both as fractions of the
    inner bbox. A cell's lattice has ((finest / 4 before step 10000, else
    finest / 2) / 2) / grid points a side (at least 1)."""
    grid = occupied_grid
    for _ in range(int(sub_split)):
        grid = grid.repeat(2, axis=0).repeat(2, axis=1).repeat(2, axis=2)
    res = np.array(grid.shape, np.int64)
    total_res = np.asarray(finest_resolution) / (4.0 if step < 10000 else 2.0)
    sample_res = np.maximum((total_res / 2.0 / res).astype(np.int64), 1)
    locs = np.stack(np.nonzero(grid), axis=-1)
    gx, gy, gz = np.meshgrid(*(np.arange(int(n)) for n in sample_res), indexing="ij")
    lattice = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    lattice = lattice / (sample_res.astype(np.float32) * res.astype(np.float32))
    return locs, res, locs.astype(np.float32) / res.astype(np.float32), lattice


def cell_max_alpha(params: FieldParams, state: FieldState, step: int,
                   finest_resolution, sub_split: int, chunk_cells: int = 4096,
                   backend: str = "xla") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pruning query: (occupied cells of the split grid [C, 3], its
    shape [3], each cell's largest alpha [C] f32 over its lattice)."""
    locs, res, corners, lattice = query_lattice(state.occupied_grid.cpu().numpy(), step,
                                                finest_resolution, sub_split)
    dev = params.features.device
    stepf = torch.tensor(float(step), device=dev)
    alpha = np.zeros(len(locs), np.float32)
    with torch.no_grad():
        for i in range(0, len(locs), chunk_cells):
            # fractions of the inner bbox -> contract space [-1, 1]
            pts = (corners[i:i + chunk_cells, None, :] + lattice[None]) * 2.0 - 1.0
            sigma = field_lib.field_inference_sigma(
                params, state, torch.from_numpy(pts).to(dev), stepf, backend=backend)[..., 0]
            alpha[i:i + chunk_cells] = (1.0 - torch.exp(-sigma)).amax(dim=-1).cpu().numpy()
    return locs, res, alpha


def prune_occupancy(params: FieldParams, state: FieldState, step: int, finest_resolution,
                    sub_split: int, pruning_th: float, chunk_cells: int = 4096,
                    backend: str = "xla") -> FieldState:
    """A new FieldState whose grid keeps the cells of ``cell_max_alpha``
    above ``pruning_th``. ``sub_split`` is the number of 2x splits toward
    the ladder's target (it can jump several rungs at one event);
    ``backend`` is the table's layout (``field.effective_backend``)."""
    locs, res, alpha = cell_max_alpha(params, state, step, finest_resolution, sub_split,
                                      chunk_cells, backend)
    grid = np.zeros(tuple(res), bool)
    kept = locs[alpha > pruning_th]
    grid[kept[:, 0], kept[:, 1], kept[:, 2]] = True
    return dataclasses.replace(state, occupied_grid=torch.from_numpy(grid).to(
        state.occupied_grid.device))


class PruningSchedule:
    """The GRID_LOG2DIM / PRUNING_TH ladder: an event fires at every
    ``dynamic_step`` (5000) multiple up to TOTAL_STEP - 10000 inclusive;
    its target log2dim and threshold are indexed by step // ADJUST_STEP,
    each clamped to its list's last entry."""

    def __init__(self, grid_log2dims: list[int], pruning_ths: list[float], adjust_step: int,
                 total_step: int | None = None, dynamic_step: int = 5000):
        self.log2dims = list(grid_log2dims)
        self.ths = list(pruning_ths)
        self.adjust_step = adjust_step
        self.dynamic_step = dynamic_step
        self.dynamic_end = total_step - 10000 if total_step else None
        self._last_log2dim = self.log2dims[0]

    def should_prune(self, step: int, round_size: int = 1) -> bool:
        """True when an event multiple falls inside the round (step -
        round_size, step]: the trainer sees only round boundaries, which
        need not divide 5000. The cap applies to the multiple itself."""
        if step <= 0:
            return False
        lo = max(step - round_size, 0)
        if step // self.dynamic_step <= lo // self.dynamic_step:
            return False
        m = (step // self.dynamic_step) * self.dynamic_step
        return self.dynamic_end is None or m <= self.dynamic_end

    def params_at(self, step: int) -> tuple[int, float]:
        """(log2dim, threshold) of the event at ``step``."""
        i = min(step // self.adjust_step, len(self.log2dims) - 1)
        j = min(step // self.adjust_step, len(self.ths) - 1)
        return self.log2dims[i], self.ths[j]

    def next_at(self, step: int) -> tuple[int, float]:
        """(n_subdivisions, threshold) of this event: the 2x splits from
        the last applied rung to the target, and the rung applied."""
        log2dim, th = self.params_at(step)
        n_split = max(log2dim - self._last_log2dim, 0)
        self._last_log2dim = max(log2dim, self._last_log2dim)
        return n_split, th
