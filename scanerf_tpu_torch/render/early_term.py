"""Early ray termination with alive-ray compaction for the windowed
renderer (counterpart of ``scanerf_tpu/render/early_term.py``).

The reference stops marching a ray once its transparency falls to 1e-5.
Here the fg samples of a chunk are evaluated ``slab`` samples at a time:

1. the CDF sample positions and the exit-tile slots are computed once for
   the whole chunk (``_prelude``: B1 and the slot geometry);
2. after each slab the carried transparency decides which rays are still
   alive; those rays are compacted (``torch.nonzero_static``) into a batch
   whose size is the alive count rounded up to a power of two, padded
   with a dummy row N that absorbs the fill, and only that batch's
   (sample, tile) rows enter the next slab's sorted stream (B2, then B7,
   or B3 and the decoder in PyTorch when unfused);
3. the background runs once, only for rays that still have transparency
   left and a tile exit, compacted the same way.

The host reads one scalar a slab, the alive count. The buckets, the
dummy row and the order of the sums are the JAX package's, so the row
counts in ``stats`` equal its own and the outputs agree to f32 rounding.
With ``term_eps=0`` no ray terminates and the result is the one-shot
render's up to float associativity.
"""

from __future__ import annotations

import torch

from scanerf_tpu_torch.ops.sampling import inverse_z_vals
from scanerf_tpu_torch.render import renderer as R
from scanerf_tpu_torch.render.renderer import MAX_PTS_BLOCKS


def _bucket(cnt: int, n: int, bmin: int) -> int:
    """Alive count -> batch size: the next power of two, clamped to
    [bmin, n] (never above the chunk)."""
    m = 1 << max(int(cnt) - 1, 0).bit_length()
    return max(min(max(m, bmin), n), 1)


def _prelude(scene, rays_o, rays_d, num_sample: int, num_march: int, max_blend_tiles: int):
    """Whole-chunk sampling and exit-slot geometry (once per chunk)."""
    z_vals, dists, valid = R._sample_union(scene, rays_o, rays_d, num_sample, num_march)
    bg_tiles, bg_w, far, bg_valid = R._exit_slots(
        scene, rays_o, rays_d, min(max_blend_tiles, scene.n_tiles))
    return z_vals, dists, valid, bg_tiles, bg_w, far, bg_valid


def _gather_fg(idx, ro_p, rd_p, z_p, d_p, valid_p, T_p, j0: int, slab: int):
    z = z_p[:, j0:j0 + slab]
    d = d_p[:, j0:j0 + slab]
    return ro_p[idx], rd_p[idx], z[idx], d[idx], valid_p[idx], T_p[idx]


def _fg_slab_eval(scene, ro, rd, z_slab, dists_slab, valid, T_in, max_blend_tiles: int,
                  fuse_decoder: bool):
    """One depth slab of the fg blend, composited against the carried
    transparency ``T_in`` -> (rgb_add, depth_add, T_out)."""
    M = z_slab.shape[0]
    Kf = min(max_blend_tiles, scene.n_tiles)
    dnorm = torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    X, TID, DIR, DEAD, slots = R._fg_rows(scene, ro, rd, z_slab, valid, Kf)
    rows = R._eval_rows(scene, X, TID, DIR, DEAD, fuse_decoder)
    alpha, color = R._fg_blend(rows, slots, dists_slab, dnorm, valid)
    trans = T_in[:, None] * torch.cumprod(
        torch.cat([torch.ones((M, 1), device=ro.device), 1.0 - alpha], dim=1), dim=1)[:, :-1]
    rgb_add = (trans[..., None] * color).sum(dim=1)
    depth_add = (trans * alpha * z_slab).sum(dim=1)
    T_out = trans[:, -1] * (1.0 - alpha[:, -1])
    return rgb_add, depth_add, T_out


def _scatter_fg(rgb_p, depth_p, T_p, idx, rgb_add, depth_add, T_out, valid, eps: float):
    """Add a slab's contributions into the padded chunk state (row N takes
    the fill rows), and return the next alive mask and its count."""
    rgb_p = rgb_p.index_add(0, idx, rgb_add)
    depth_p = depth_p.index_add(0, idx, depth_add)
    T_p = T_p.index_put((idx,), T_out)
    alive = valid & (T_p[:-1] > eps)
    return rgb_p, depth_p, T_p, alive, alive.sum()


def _bg_eval(scene, ro, rd, bg_tiles, bg_w, far, bg_valid, num_bg_sample: int,
             invalid_underground: bool, fuse_decoder: bool):
    """Background pass of the compacted rays -> (rgb_bg, depth_bg), for
    the caller to weigh by the carried fg transparency."""
    z_bg, d_bg = inverse_z_vals(far, num_bg_sample)
    X, TID, DIR, DEAD = R._bg_rows(scene, ro, rd, z_bg, bg_tiles, bg_w, bg_valid)
    rows = R._eval_rows(scene, X, TID, DIR, DEAD, fuse_decoder)
    return R._bg_blend(scene, rows, ro, rd, z_bg, d_bg, bg_tiles, bg_w, bg_valid,
                       invalid_underground)


def render_rays_early(scene, rays_o, rays_d, num_sample: int = 128, num_bg_sample: int = 128,
                      num_march: int = 512, invalid_underground: bool = False,
                      max_blend_tiles: int = MAX_PTS_BLOCKS, fuse_decoder: bool = True,
                      slab: int = 32, term_eps: float = 1e-5, bucket_min: int = 512,
                      stats: dict | None = None, device="cuda") -> dict:
    """Early-termination render of one chunk of rays (windowed tiles with
    a shared resolution ladder), on ``device``, the scene's. Same outputs
    as ``renderer.render_rays``, within the T < ``term_eps`` truncation.
    ``slab`` fg samples are evaluated between compactions (it must divide
    ``num_sample``). ``stats``, when given, accumulates across calls:
    n_rays, fg_rows, bg_rows (rows evaluated, fill rows included),
    full_fg_rows, full_bg_rows (the one-shot render's) and slabs, a list
    of (alive count, batch size) a slab."""
    R._check_device(scene, device)
    if R._resolve_backend(scene, "auto") != "windowed":
        raise ValueError("early termination needs windowed-layout tiles with a shared "
                         "resolution ladder")
    if num_sample % slab:
        raise ValueError(f"slab {slab} must divide num_sample {num_sample}")
    dev = scene.device
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)
    N = rays_o.shape[0]
    Kf = Kb = min(max_blend_tiles, scene.n_tiles)
    z_vals, dists, valid, bg_tiles, bg_w, far, bg_valid = _prelude(
        scene, rays_o, rays_d, num_sample, num_march, max_blend_tiles)

    def pad1(a, fill=0.0):  # one dummy row at index N absorbs the fill rows
        return torch.cat([a, torch.full((1,) + a.shape[1:], fill, dtype=a.dtype, device=dev)])

    ro_p = pad1(rays_o)
    rd_p = pad1(rays_d)
    rd_p[N] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    z_p, d_p, valid_p = pad1(z_vals), pad1(dists), pad1(valid)
    T_p = torch.ones((N + 1,), device=dev)
    rgb_p = torch.zeros((N + 1, 3), device=dev)
    depth_p = torch.zeros((N + 1,), device=dev)

    alive = valid
    cnt = int(alive.sum())
    st = {"n_rays": N, "fg_rows": 0, "bg_rows": 0, "slabs": [],
          "full_fg_rows": N * num_sample * Kf, "full_bg_rows": N * num_bg_sample * Kb}
    for j in range(num_sample // slab):
        if cnt == 0:
            break
        M = _bucket(cnt, N, bucket_min)
        idx = torch.nonzero_static(alive, size=M, fill_value=N)[:, 0]
        ro, rd, z, dd, vv, Ti = _gather_fg(idx, ro_p, rd_p, z_p, d_p, valid_p, T_p,
                                           j * slab, slab)
        rgb_add, depth_add, T_out = _fg_slab_eval(scene, ro, rd, z, dd, vv, Ti,
                                                  max_blend_tiles, fuse_decoder)
        rgb_p, depth_p, T_p, alive, cnt_dev = _scatter_fg(
            rgb_p, depth_p, T_p, idx, rgb_add, depth_add, T_out, valid, term_eps)
        st["slabs"].append((cnt, M))
        st["fg_rows"] += M * slab * Kf
        cnt = int(cnt_dev)  # the slab's one host sync

    rgb_fg = rgb_p  # before the background adds in
    alive_bg = (T_p[:-1] > term_eps) & bg_valid
    cnt_bg = int(alive_bg.sum())
    if cnt_bg > 0:
        Mb = _bucket(cnt_bg, N, bucket_min)
        idxb = torch.nonzero_static(alive_bg, size=Mb, fill_value=N)[:, 0]
        rgb_b, depth_b = _bg_eval(
            scene, ro_p[idxb], rd_p[idxb], pad1(bg_tiles)[idxb], pad1(bg_w)[idxb],
            pad1(far, 0.1)[idxb], pad1(bg_valid)[idxb], num_bg_sample, invalid_underground,
            fuse_decoder)
        Tb = T_p[idxb]
        rgb_p = rgb_p.index_add(0, idxb, Tb[:, None] * rgb_b)
        depth_p = depth_p.index_add(0, idxb, Tb * depth_b)
        st["bg_rows"] = Mb * num_bg_sample * Kb
    if stats is not None:
        for k, v in st.items():
            if k == "slabs":
                stats.setdefault("slabs", []).extend(v)
            else:
                stats[k] = stats.get(k, 0) + v
    return {"rgb": rgb_p[:N].clamp(0.0, 1.0), "depth": depth_p[:N, None],
            "rgb_fg": rgb_fg[:N], "T_left": T_p[:N], "fore_valid": valid}
