"""Plain PyTorch training step of one tile, the benchmark's reference.

One step of ScaNeRF's per-tile recipe from a batch of 2x2 pixel patches:
rays through the refined poses, the fg (occupancy CDF) and bg
(inverse-depth) samples, the windowed hash and ShallowMLP, the composite,
the RGB, depth-consistency, depth-smoothness and multi-view warp losses
(with the warp's no-grad re-render along the neighbour rays), the
specular L2 term, the gradients of the tables, the decoder and the pose
refinements, and Adam in three groups (tables; decoder with the decay
1e-6 * param added to the gradient; poses), each at an exponential
learning-rate schedule.

It is computed in blocks of rays so that it fits beside nothing else on
the card: a first pass renders every block without a graph and keeps the
per-ray outputs; the losses are taken over those outputs, held as
leaves; a second pass renders each block again under autograd and pulls
the per-ray cotangents back into the tables, the decoder and the rays;
the rays' cotangents finally reach the poses. Rendering is deterministic,
so the two passes see the same samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import field as F


@dataclasses.dataclass
class Recipe:
    """The training step's numbers (the configuration's ``TRAINING``)."""

    num_sample: int
    num_bg_sample: int
    num_march: int
    total_step: int
    w_rgb: float
    w_warp: float
    w_depth: float
    w_smooth: float
    warp_warming: bool
    alpha: float
    gamma: float
    warp_top_k: int
    warp_vis: tuple  # (fg samples, bg samples, march) of the re-render
    eta: tuple  # (tables, decoder, poses)
    l2_specular: float = 0.01

    @classmethod
    def from_config(cls, cfg: dict) -> "Recipe":
        T, L = cfg["TRAINING"], cfg["TRAINING"]["LOSS"]
        for k in ("RGB_LOSS_START", "WARP_LOSS_START", "DEPTH_LOSS_START",
                  "DEPTH_SMOOTH_LOSS_START"):
            if L[k] != 0:
                raise ValueError(f"the reference starts every loss at 0, not {k}={L[k]}")
        if T["BG_MODE"] != "IZ" or cfg["RHO"] != 0 or not T["CAMOPT"]["ENABLE"] \
                or T["CAMOPT"]["START_STEPS"] != 0:
            raise ValueError("the reference runs IZ backgrounds, RHO 0 and poses refined "
                             "from step 0")
        return cls(num_sample=T["NUM_SAMPLE"], num_bg_sample=T["NUM_BG_SAMPLE"],
                   num_march=T["NUM_MARCH"], total_step=T["TOTAL_STEP"],
                   w_rgb=L["WEIGHT_RGB_LOSS"], w_warp=L["WEIGHT_WARP_LOSS"],
                   w_depth=L["WEIGHT_DEPTH_LOSS"], w_smooth=L["WEIGHT_DEPTH_SMOOTH_LOSS"],
                   warp_warming=L["WARP_WARPING"], alpha=L["ALPHA"], gamma=L["GAMMA"],
                   warp_top_k=L["WARP_TOP_K"],
                   warp_vis=(L["WARP_VIS_SAMPLE"], L["WARP_VIS_BG_SAMPLE"],
                             L["WARP_VIS_MARCH"]),
                   eta=(T["ETA"]["HASH_FEATURE"], T["ETA"]["DECODER"], T["ETA"]["CAM"]))


def lr_at(start: float, total: int, count: int) -> float:
    """start * 0.1 ** (count / total) in f32 (the rate falls to a tenth at
    ``total`` steps), 0 from ``total`` on."""
    s = np.float32(count)
    eta = np.float32(start) * np.float32(0.1) ** (s / np.float32(total))
    return float(eta) if s < total else 0.0


class Tile:
    """A tile's static inputs: the doubled box, the occupancy grid over its
    inner half, the level resolutions, and the cameras' images, depths,
    normals, intrinsics and base world-to-camera poses."""

    def __init__(self, scene: dict, device):
        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.min_bbox, self.size = t(scene["min_bbox"]), t(scene["bbox_size"])
        self.grid = t(scene["occupied"], torch.bool)
        self.res = t(scene["resolutions"], torch.int64)
        self.images, self.depths = t(scene["images"]), t(scene["depths"])
        self.normals, self.ks = t(scene["normals"]), t(scene["ks"])
        self.rts = F.pose_invert(t(scene["c2ws"]))

    def contract_fg(self, x):
        return (x - self.min_bbox) / self.size * 4.0 - 2.0

    def contract_bg(self, x):
        x = (x - self.min_bbox) / self.size * 4.0 - 2.0
        linf = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-9)
        return x * ((2.0 - 1.0 / linf) / linf)


def render(tile: Tile, tables, dec, rays_o, rays_d, Sf: int, Sb: int, march: int, wf):
    """fg + bg render of rays [N, 3] -> per-ray color, depth, diffuse,
    specular [N, ...], the specular-square terms s2f, s2b [N] and the
    valid masks vf, vb."""
    B = rays_o.shape[0]
    with torch.no_grad():
        zf, df, vf = F.fg_samples(rays_o, rays_d, Sf, tile.grid, tile.min_bbox + tile.size / 4,
                                  tile.size / 2, march)
        zb, db, vb = F.bg_samples(rays_o, rays_d, Sb, tile.min_bbox + tile.size / 2, tile.size)
    zero = torch.zeros((), device=rays_o.device)
    zf, df = torch.where(vf[:, None], zf, zero), torch.where(vf[:, None], df, zero)
    zb, db = torch.where(vb[:, None], zb, zero), torch.where(vb[:, None], db, zero)
    xf = tile.contract_fg(rays_o[:, None, :] + zf[..., None] * rays_d[:, None, :])
    xb = tile.contract_bg(rays_o[:, None, :] + zb[..., None] * rays_d[:, None, :])
    x = torch.cat([xf.reshape(-1, 3), xb.reshape(-1, 3)])
    dirs = torch.cat([rays_d[:, None, :].expand(B, Sf, 3).reshape(-1, 3),
                      rays_d[:, None, :].expand(B, Sb, 3).reshape(-1, 3)])
    out = F.decode(dec, F.encode(x, tables, tile.res) * wf.repeat_interleave(2), dirs)
    cols = torch.cat([out["sigma"], out["diffuse"], out["tint"] * out["specular"],
                      (out["specular"] ** 2).mean(dim=-1, keepdim=True)], dim=-1)
    parts = []
    for rows, z, d, v, S, inf in ((cols[:B * Sf], zf, df, vf, Sf, False),
                                  (cols[B * Sf:], zb, db, vb, Sb, True)):
        c = rows.reshape(B, S, 8)
        w, T = F.integrate(c[..., 0], d, rays_d, inf)
        w = torch.where(v[:, None], w, torch.zeros_like(w))
        T = torch.where(v, T, torch.ones_like(T))
        diffuse = (w[..., None] * c[..., 1:4]).sum(1)
        specular = (w[..., None] * c[..., 4:7]).sum(1)
        parts.append({"rgb": (diffuse + specular).clamp(0.0, 1.0), "depth": (w * z).sum(1),
                      "diffuse": diffuse, "specular": specular, "T": T,
                      "s2": (w.detach() * c[..., 7]).sum(1)})
    fg, bg = parts
    T = fg["T"][:, None]
    return {"color": fg["rgb"] + T * bg["rgb"], "depth": (fg["depth"] + T[:, 0] * bg["depth"]),
            "diffuse": fg["diffuse"] + T * bg["diffuse"],
            "specular": fg["specular"] + T * bg["specular"],
            "s2f": fg["s2"], "s2b": bg["s2"], "vf": vf, "vb": vb}


OUT_KEYS = ("color", "depth", "diffuse", "specular", "s2f", "s2b")


def _normalize(v, eps=1e-12):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def masked_mean(x, m):
    return (x * m).sum() / m.sum().clamp_min(1.0)


def depth_loss(rend, mono, mask):
    """Per-camera scale-and-shift aligned MSE of depths [N, B, 1]."""
    a00 = (mask * rend * rend).sum(dim=(1, 2))
    a01 = (mask * rend).sum(dim=(1, 2))
    a11 = mask.sum(dim=(1, 2))
    b0 = (mask * rend * mono).sum(dim=(1, 2))
    b1 = (mask * mono).sum(dim=(1, 2))
    det = a00 * a11 - a01 * a01
    ok = det != 0
    sd = torch.where(ok, det, torch.ones_like(det))
    h0 = torch.where(ok, (a11 * b0 - a01 * b1) / sd, torch.zeros_like(det))
    h1 = torch.where(ok, (-a01 * b0 + a00 * b1) / sd, torch.zeros_like(det))
    return masked_mean((rend * h0[:, None, None] + h1[:, None, None] - mono) ** 2, mask)


def smooth_loss(ks, locs, rend, normals, mask):
    """Depth gradients of 2x2 patches against the monocular normals."""
    N = ks.shape[0]
    h = torch.cat([locs.to(rend.dtype), torch.ones_like(locs[..., :1], dtype=rend.dtype)], -1)
    pc = (torch.einsum("nij,nbj->nbi", torch.linalg.inv(ks), h) * rend).reshape(N, -1, 2, 2, 3)
    nrm = normals.reshape(N, -1, 2, 2, 3)
    m = mask.reshape(N, -1, 4)
    mean_n = nrm.mean(dim=(2, 3))
    sim = (nrm * mean_n[:, :, None, None, :]).sum(dim=-1)
    ok = (sim.reshape(N, -1, 4) > 0.9).all(dim=-1) & m.bool().all(dim=-1)
    mn = _normalize(mean_n)
    gy = _normalize(pc[:, :, 1] - pc[:, :, 0])
    gx = _normalize(pc[:, :, :, 1] - pc[:, :, :, 0])
    cos = 0.5 * (mn[:, :, None, :] * gy).sum(-1).abs().mean(-1) \
        + 0.5 * (mn[:, :, None, :] * gx).sum(-1).abs().mean(-1)
    return masked_mean(cos, ok.to(cos.dtype))


class Reference:
    """The reference's trainable state (per-level tables, the decoder, the
    pose refinements) and Adam moments, stepped from a batch at a time."""

    def __init__(self, tile: Tile, recipe: Recipe, table, decoder_vec, step: int,
                 block: int = 4096):
        L = table.shape[0]
        self.tile, self.r, self.block, self.step = tile, recipe, block, step
        self.tables = [table[lvl].view(-1, 2).detach().requires_grad_() for lvl in range(L)]
        d = F.unpack_decoder(decoder_vec)
        self.dec = {n: {k: d[n][k].detach().clone().requires_grad_() for k in ("w", "b")}
                    for n in F.DECODER_SHAPES}
        self.se3 = torch.zeros((tile.ks.shape[0], 6), device=table.device, requires_grad=True)
        self.moments = {}
        self.count = 0  # Adam's own step count (bias correction)

    def leaves(self) -> dict:
        out = {"hash": self.tables}
        for n in F.DECODER_SHAPES:
            for k in ("w", "b"):
                out[f"{n}.{k}"] = [self.dec[n][k]]
        out["cam"] = [self.se3]
        return out

    def _rays(self, se3, ray_idx):
        W = self.tile.images.shape[2]
        xy = torch.stack([(ray_idx % W).float() + 0.5,
                          torch.div(ray_idx, W, rounding_mode="floor").float() + 0.5], -1)
        rts = F.pose_compose(F.se3_exp(se3), self.tile.rts)
        o, d = F.rays_from(xy, rts, self.tile.ks)
        return o.reshape(-1, 3), d.reshape(-1, 3), rts

    def _render_all(self, tables, dec, ro, rd, Sf, Sb, march, wf):
        outs = [render(self.tile, tables, dec, ro[i:i + self.block], rd[i:i + self.block],
                       Sf, Sb, march, wf) for i in range(0, ro.shape[0], self.block)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _warp(self, out, ro, rd, rts, gt_valid, wf):
        """The multi-view warp loss of the rendered rays."""
        t, r = self.tile, self.r
        N_cam, H, W = t.images.shape[:3]
        pts = ro + out["depth"][:, None] * rd
        top_k = min(r.warp_top_k, N_cam)
        with torch.no_grad():  # view selection
            p, rts_d = pts.detach(), rts.detach()
            R, tt = rts_d[..., :3], rts_d[..., 3]
            centers = -torch.einsum("nij,ni->nj", R, tt)
            xc = torch.einsum("nij,bj->nbi", R, p) + tt[:, None, :]
            uvz = torch.einsum("nij,nbj->nbi", t.ks, xc)
            z = uvz[..., 2]
            zs = torch.where(z == 0, torch.ones_like(z), z)
            x, y = uvz[..., 0] / zs, uvz[..., 1] / zs
            out_v = (z <= 0.001) | (x <= 0) | (x >= W - 1) | (y <= 0) | (y >= H - 1)
            ang = 1.0 - (_normalize(rd)[None] * _normalize(p[None] - centers[:, None, :])).sum(-1)
            d_ref = torch.linalg.vector_norm(p[None] - ro[None], dim=-1)
            d_nei = torch.linalg.vector_norm(p[None] - centers[:, None, :], dim=-1).clamp_min(1e-8)
            cost = 0.9 * ang + 0.1 * (1.0 - d_ref / d_nei).clamp_min(0.0)
            cost = torch.where(out_v, torch.ones_like(cost), cost).t()
            vals, idx = torch.sort(cost, dim=-1, stable=True)
            views, nvalid = idx[:, :top_k], vals[:, :top_k] <= 0.176
        Rk, tk = rts[views][..., :3], rts[views][..., 3]
        xk = torch.einsum("bkij,bj->bki", Rk, pts) + tk
        uvz = torch.einsum("bkij,bkj->bki", t.ks[views], xk)
        zk = uvz[..., 2:]
        grid = uvz[..., :2] / (zk + 1e-8) - 0.5
        nei_o = (-torch.einsum("bkij,bki->bkj", Rk, tk)).detach()
        nei_d = torch.einsum("bkij,bki->bkj", Rk, xk / (xk[..., 2:] + 1e-8)).detach()
        proj = zk.detach()
        lt = torch.floor(grid).to(torch.int64)
        off = grid - lt.to(grid.dtype)
        near = torch.floor(grid + 0.5).to(torch.int64)

        def fetch(ix, iy):
            return t.images[views, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]

        ox, oy = off[..., 0:1], off[..., 1:2]
        color = (1 - ox) * (1 - oy) * fetch(lt[..., 0], lt[..., 1]) \
            + ox * (1 - oy) * fetch(lt[..., 0] + 1, lt[..., 1]) \
            + (1 - ox) * oy * fetch(lt[..., 0], lt[..., 1] + 1) \
            + ox * oy * fetch(lt[..., 0] + 1, lt[..., 1] + 1)
        inb = (lt[..., 0] >= 0) & (lt[..., 0] + 1 <= W - 1) & (lt[..., 1] >= 0) \
            & (lt[..., 1] + 1 <= H - 1)
        nvalid = nvalid & inb  # every pixel is unoccluded
        B, K = views.shape
        with torch.no_grad():
            tabs = [tb.detach() for tb in self.tables]
            dec = {n: {k: v.detach() for k, v in p.items()} for n, p in self.dec.items()}
            nei = self._render_all(tabs, dec, nei_o.reshape(-1, 3), nei_d.reshape(-1, 3),
                                   *r.warp_vis, wf)
        voxel = (t.size / t.res[-1].max().to(torch.float32)).max()
        vis = torch.exp(-r.alpha * (nei["depth"].reshape(B, K, 1) - proj).abs() / voxel)
        nd = torch.exp(-r.gamma * nei["specular"].reshape(B, K, 3).mean(-1, keepdim=True))
        score = torch.where(nvalid[..., None], vis * nd, torch.zeros_like(vis))
        ref = torch.exp(-r.gamma * out["specular"].mean(-1, keepdim=True)).detach()
        score = score * ref[:, None, :]
        pred = (out["diffuse"] + out["specular"]).clamp(0.0, 1.0)
        mse = ((pred[:, None, :] - color) ** 2).mean(-1, keepdim=True)
        return (mse * score * gt_valid[:, None, None]).sum() \
            / (gt_valid.to(mse.dtype).sum().clamp_min(1.0) * top_k)

    def _loss(self, out, ro, rd, rts, ray_idx, locs, step):
        t, r = self.tile, self.r
        N_cam, H, W = t.images.shape[:3]
        B = ray_idx.shape[0]
        valid = out["vf"] | out["vb"]
        vf, vb = out["vf"].float(), out["vb"].float()
        loss = r.l2_specular * ((out["s2f"] * vf).sum() / vf.sum().clamp_min(1.0)
                                + (out["s2b"] * vb).sum() / vb.sum().clamp_min(1.0))
        gt = t.images.reshape(N_cam, H * W, 3)[:, ray_idx].reshape(-1, 3)
        vm = valid.float()
        loss = loss + r.w_rgb * masked_mean(((out["color"] - gt) ** 2).mean(-1), vm)
        rend = out["depth"].reshape(N_cam, B, 1)
        mask = valid.reshape(N_cam, B, 1).float()
        in_run = 1.0 if 0 < step < r.total_step else 0.0
        mono = t.depths.reshape(N_cam, H * W)[:, ray_idx][..., None]
        loss = loss + r.w_depth * 0.1 ** (step / 30000.0) * in_run * depth_loss(rend, mono, mask)
        nrm = t.normals.reshape(N_cam, H * W, 3)[:, ray_idx]
        lc = locs[None].expand(N_cam, *locs.shape)
        loss = loss + r.w_smooth * 0.1 ** (step / 30000.0) * in_run \
            * smooth_loss(t.ks, lc, rend, nrm, mask)
        ww = r.w_warp * min(max(step / 10000.0, 0.0), 1.0) if r.warp_warming else r.w_warp
        return loss + ww * (1.0 if step > 0 else 0.0) * self._warp(out, ro, rd, rts, valid,
                                                                   barf_of(self))

    def grads(self, ray_idx, locs):
        """(loss, {leaf: [gradients]}) of one batch at the current state."""
        r, step = self.r, self.step
        wf = barf_of(self)
        with torch.no_grad():
            ro, rd, _ = self._rays(self.se3, ray_idx)
            out = self._render_all(self.tables, self.dec, ro, rd, r.num_sample,
                                   r.num_bg_sample, r.num_march, wf)
        leaf = {k: out[k].detach().requires_grad_() for k in OUT_KEYS}
        leaf.update(vf=out["vf"], vb=out["vb"])
        ro_l, rd_l = ro.detach().requires_grad_(), rd.detach().requires_grad_()
        se3 = self.se3.detach().requires_grad_()
        rts = F.pose_compose(F.se3_exp(se3), self.tile.rts)
        loss = self._loss(leaf, ro_l, rd_l, rts, ray_idx, locs, step)
        g = torch.autograd.grad(loss, [leaf[k] for k in OUT_KEYS] + [ro_l, rd_l, se3],
                                allow_unused=True)
        g_out = dict(zip(OUT_KEYS, g[:len(OUT_KEYS)]))
        g_ro, g_rd, g_se3 = (x if x is not None else torch.zeros_like(y)
                             for x, y in zip(g[len(OUT_KEYS):], (ro, rd, self.se3)))
        params = self.tables + [self.dec[n][k] for n in F.DECODER_SHAPES for k in ("w", "b")]
        for p in params:
            p.grad = None
        for i in range(0, ro.shape[0], self.block):
            sl = slice(i, i + self.block)
            ob, db = ro[sl].clone().requires_grad_(), rd[sl].clone().requires_grad_()
            o = render(self.tile, self.tables, self.dec, ob, db, r.num_sample,
                       r.num_bg_sample, r.num_march, wf)
            used = [k for k in OUT_KEYS if g_out[k] is not None]
            torch.autograd.backward([o[k] for k in used], [g_out[k][sl] for k in used])
            g_ro[sl] += ob.grad
            g_rd[sl] += db.grad
        se3 = self.se3.detach().requires_grad_()
        ro2, rd2, _ = self._rays(se3, ray_idx)
        (g_cam,) = torch.autograd.grad([ro2, rd2], [se3], [g_ro, g_rd])
        grads = {"hash": [p.grad if p.grad is not None else torch.zeros_like(p)
                          for p in self.tables]}
        for n in F.DECODER_SHAPES:
            for k in ("w", "b"):
                p = self.dec[n][k]
                grads[f"{n}.{k}"] = [p.grad if p.grad is not None else torch.zeros_like(p)]
        grads["cam"] = [g_cam + g_se3]
        for p in params:
            p.grad = None
        return loss.detach(), grads

    @torch.no_grad()
    def apply(self, grads: dict) -> dict:
        """One Adam update in place -> the gradients as Adam took them
        (the decoder's with its decay added)."""
        r, leaves = self.r, self.leaves()
        self.count += 1
        c = self.count
        taken = {}
        for name, ps in leaves.items():
            group = "hash" if name == "hash" else ("cam" if name == "cam" else "decoder")
            b1, b2, eps = (0.9, 0.99, 1e-15) if group == "hash" else (0.9, 0.999, 1e-8)
            eta = {"hash": r.eta[0], "decoder": r.eta[1], "cam": r.eta[2]}[group]
            lr = lr_at(eta, r.total_step, self.step)
            taken[name] = []
            for p, g in zip(ps, grads[name]):
                if group == "decoder":
                    g = g + 1e-6 * p
                taken[name].append(g)
                m, v = self.moments.setdefault(id(p), (torch.zeros_like(p), torch.zeros_like(p)))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2**c) ** 0.5).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1 - b1**c))
        self.step += 1
        return taken


def barf_of(ref: Reference) -> torch.Tensor:
    return F.barf_weights(float(ref.step), len(ref.tables)).to(ref.se3.device)


def leaf_norms(tensors: dict) -> dict:
    """{leaf: its L2 norm over all its tensors} in f64."""
    return {k: float(torch.sqrt(sum((t.double() ** 2).sum() for t in v))) for k, v in
            tensors.items()}
