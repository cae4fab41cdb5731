"""Plain PyTorch reference of the NOF training step (the published
BundleSDF NeRF step: reference nerf_runner.py render_rays, sdf2weights,
get_sdf_loss, the inf-norm clip and Adam), written from the
configuration's numbers alone.  It imports nothing of the program.

One step: the batch rows and sampling jitter come from the benchmark's
draws; the occupancy march over the grid puts ``N_samples`` samples in the
occupied part of each ray's [-1, 1]^3 chord (clipped at the depth plus the
truncation) and ``N_samples_around_depth`` in the truncation band (in the
occupied chord for rays without valid depth); the per-frame pose
correction (tanh-bounded se(3), frame 0 pinned) moves the rays; the
multiresolution hash grid (dense row-major levels while ``(res+1)^3`` fits
the table, the spatial hash beyond) is blended trilinearly, the big dense
levels' values rounded to the staging precision; degree-3 spherical
harmonics of the view direction, the frame features, the sigma and color
MLPs; ``sdf2weights``' bell at the measured depth; the colour, free-space,
empty and truncated-SDF losses and the frame-feature regulariser; autograd
for the gradient (summed in float32); the global inf-norm clip and Adam
(eps 1e-15, the learning rate decayed every 10 updates).  Microbatches of
equal size, as the configuration implies, are averaged.

``precision="ref"`` computes in float32 with TF32 off and the big levels
rounded to bfloat16, as the configuration states.  ``precision="control"``
is the control, one precision below: TF32 matmuls and the big levels in
per-tensor scaled float8 (e4m3).
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..costs import grid_levels

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-15
RAY_DIR, RAY_RGB, RAY_DEPTH, RAY_FRAME_ID, RAY_TYPE = slice(0, 3), slice(3, 6), 6, 8, 9
_PRIMES = (1, 2654435761, 805459861)
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)


# ------------------------------------------------------------ the weights ---
# (the grid's levels: ``costs.grid_levels``, the yardstick's one account of
# the table's layout)

def make_params(cfg: dict, n_frames: int, seed: int, device) -> dict:
    """Initial weights from ``seed`` on ``device``, with the reference's
    distributions: the table U(-1e-4, 1e-4); every linear layer U(+-1/sqrt
    (fan_in)) (torch.nn.Linear's), weights stored (in, out); the sigma
    net's last bias 0.1; the pose corrections 0; frame features N(0, 1).
    ``n_frames``: the rows of the pose and feature arrays."""
    from ..draws import mix

    gen = torch.Generator(device=device).manual_seed(mix(seed, 3))
    C = int(cfg["feature_grid_dim"])
    n_table = sum(p["size"] for p in grid_levels(cfg)) * C
    hidden, geo = 64, 15
    sigma_in = int(cfg["num_levels"]) * C
    ff = int(cfg["frame_features"])
    color_in = int(cfg["multires_views"]) ** 2 + ff + geo

    def uniform(shape, bound):
        return torch.rand(shape, generator=gen, device=device) * (2 * bound) - bound

    def linear(fan_in, fan_out):
        b = 1.0 / math.sqrt(fan_in)
        return uniform((fan_in, fan_out), b), uniform((fan_out,), b)

    params = {"table": uniform((n_table,), 1e-4)}
    w0, b0 = linear(sigma_in, hidden)
    w1, _ = linear(hidden, 1 + geo)
    params["sigma"] = {"w0": w0, "b0": b0, "w1": w1,
                       "b1": torch.full((1 + geo,), 0.1, device=device)}
    c = {}
    for i, (a, b) in enumerate(((color_in, hidden), (hidden, hidden), (hidden, 3))):
        c[f"w{i}"], c[f"b{i}"] = linear(a, b)
    params["color"] = c
    params["pose_array"] = torch.zeros((n_frames, 6), device=device)
    if ff > 0:
        params["feature_array"] = torch.randn((n_frames, ff), generator=gen, device=device)
    return params


def named_leaves(params: dict, prefix: str = "") -> list:
    """(name, tensor) of every leaf, in the parameter dict's order."""
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += named_leaves(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def compared_leaves(cfg: dict, params: dict) -> dict:
    """The leaves that are compared: the table cut into its levels
    (``table.L<i>``), every other leaf whole."""
    C = int(cfg["feature_grid_dim"])
    out = {}
    for name, t in named_leaves(params):
        if name == "table":
            for i, p in enumerate(grid_levels(cfg)):
                out[f"table.L{i}"] = t[p["offset"] * C:(p["offset"] + p["size"]) * C]
        else:
            out[name] = t
    return out


# -------------------------------------------------------------- precision ---

def _stage(t: torch.Tensor, precision: str) -> torch.Tensor:
    """The value rounded to the staging precision, the gradient passed on
    whole (the gradient is summed in float32)."""
    with torch.no_grad():
        if precision == "ref":
            r = t.to(torch.bfloat16).to(torch.float32)
        else:
            scale = t.abs().max().clamp(min=1e-30) / 448.0
            r = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (r - t.detach())


@contextlib.contextmanager
def _matmul_precision(precision: str):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "control"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------- the step ---

def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[t, w] (n, 6) -> (n, 4, 4): Rodrigues, with the Taylor series below
    an angle of 1e-4."""
    rho, w = xi[:, :3], xi[:, 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2 + 1e-8)
    small = th2 < 1e-8
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2.clamp(min=1e-8))
    c = torch.where(small, 1 / 6 - th2 / 120, (th - torch.sin(th)) / (th2 * th).clamp(min=1e-8))
    W = _hat(w)
    WW = W @ W
    eye = torch.eye(3, device=xi.device).expand_as(W)
    R = eye + a[:, None, None] * W + b[:, None, None] * WW
    V = eye + b[:, None, None] * W + c[:, None, None] * WW
    T = torch.zeros((len(xi), 4, 4), device=xi.device)
    T = T + torch.nn.functional.pad(R, (0, 1, 0, 1))
    T = T + torch.nn.functional.pad((V @ rho[:, :, None]), (3, 0, 0, 1))
    T[:, 3, 3] = 1.0
    return T


def pose_corrections(pose_array, cfg: dict, ids):
    theta = torch.tanh(pose_array)
    xi = torch.cat([theta[:, :3] * float(cfg["max_trans"]) * float(cfg["sc_factor"]),
                    theta[:, 3:] * (float(cfg["max_rot"]) / 180.0 * math.pi)], -1)
    T = se3_exp(xi)
    eye = torch.eye(4, device=T.device).expand_as(T)
    first = (torch.arange(len(T), device=T.device) == 0)[:, None, None]
    return torch.where(first, eye, T)[ids]


def _box(o, d):
    """Entry and exit of the rays in [-1, 1]^3 (-1 on a miss)."""
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-10)
    small = torch.where(d < 0, -1e-10, 1e-10)
    inv = 1.0 / torch.where(d.abs() < 1e-10, small, d)
    t0, t1 = (-1.0 - o) * inv, (1.0 - o) * inv
    tn = torch.minimum(t0, t1).clamp(min=0.0).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    hit = tn <= tf
    return torch.where(hit, tn, -1.0), torch.where(hit, tf, -1.0)


def _occupied_samples(occ, t0, dt, n: int, u):
    """Invert the occupied-length prefix sum at stratified, jittered
    arc lengths: ``n`` distances a ray (0 for a ray in no occupied cell)."""
    M = occ.shape[1]
    cdf = torch.cumsum(torch.where(occ, dt[:, None], 0.0), -1)
    total = cdf[:, -1]
    base = (torch.arange(n, device=occ.device, dtype=torch.float32) + 0.5) / n
    s = torch.clamp(base[None] + (u - 0.5) / n, 0.0, 1.0 - 1e-6) * total[:, None]
    k = torch.searchsorted(cdf.contiguous(), s.contiguous(), right=True).clamp(0, M - 1)
    prev = torch.where(k > 0, torch.gather(cdf, 1, (k - 1).clamp(min=0)), 0.0)
    z = t0[:, None] + k.to(torch.float32) * dt[:, None] + (s - prev)
    hit = total > 1e-8
    return torch.where(hit[:, None], z, 0.0), hit


@torch.no_grad()
def sample_z(cfg: dict, grid, o, d_unit, dir_norm, depth, trunc, u_occ, u_band, u_fb,
             n_march: int):
    """z (ray-direction multiples, i.e. z-depth) of every sample, and
    whether the ray met occupied space."""
    tmin, tmax = _box(o, d_unit)
    box = tmin >= 0
    t0, t1 = torch.where(box, tmin, 0.0), torch.where(box, tmax, 0.0)
    dt = (t1 - t0) / n_march
    t_mid = t0[:, None] + (torch.arange(n_march, device=o.device) + 0.5)[None] * dt[:, None]
    R = grid.shape[0]
    occ = box[:, None].expand_as(t_mid).clone()
    idx = torch.zeros_like(t_mid, dtype=torch.int64)
    for k in range(3):
        g = torch.floor((o[:, k:k + 1] + d_unit[:, k:k + 1] * t_mid + 1.0) * 0.5 * R).long()
        occ &= (g >= 0) & (g < R)
        idx = idx * R + g.clamp(0, R - 1)
    occ &= grid.reshape(-1)[idx]
    clip = torch.where(depth > 1e-6, (depth + trunc) * dir_norm, float("inf"))
    n_s, n_b = int(cfg["N_samples"]), int(cfg["N_samples_around_depth"])
    z_occ, hit = _occupied_samples(occ & (t_mid <= clip[:, None]), t0, dt, n_s, u_occ)
    z_fb, _ = _occupied_samples(occ, t0, dt, n_b, u_fb)
    inv = 1.0 / dir_norm.clamp(min=1e-10)
    sc = float(cfg["sc_factor"])
    near, far = depth - trunc, depth + trunc * float(cfg["neg_trunc_ratio"])
    base = (torch.arange(n_b, device=o.device, dtype=torch.float32) + 0.5) / n_b
    s_u = torch.clamp(base[None] + (u_band - 0.5) / n_b, 0.0, 1.0)
    z_band = near[:, None] + s_u * (far - near)[:, None]
    ok = (depth >= float(cfg["near"]) * sc) & (depth <= float(cfg["far"]) * sc)
    z_band = torch.where(ok[:, None], z_band, z_fb * inv[:, None])
    return torch.cat([z_occ * inv[:, None], z_band], -1), hit


def encode(pts, table, cfg: dict, precision: str):
    """Trilinear multiresolution hash-grid features of ``pts`` (M, 3)."""
    C = int(cfg["feature_grid_dim"])
    x01 = torch.clamp((pts + 1.0) * 0.5, 0.0, 1.0)
    feats = []
    for p in grid_levels(cfg):
        tab = table[p["offset"] * C:(p["offset"] + p["size"]) * C].view(p["size"], C)
        if p["staged"]:
            tab = _stage(tab, precision)
        pos = x01 * p["scale"] + 0.5
        g = torch.floor(pos)
        f = pos - g
        g = g.long()
        acc = 0.0
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    gx, gy, gz = g[:, 0] + cx, g[:, 1] + cy, g[:, 2] + cz
                    if p["dense"]:
                        s = p["res"] + 1
                        idx = gx * (s * s) + gy * s + gz
                    else:
                        idx = ((gx * _PRIMES[0]) ^ (gy * _PRIMES[1]) ^ (gz * _PRIMES[2])
                               ) & 0xFFFFFFFF
                        idx = idx % p["size"]
                    w = ((f[:, 0] if cx else 1 - f[:, 0]) * (f[:, 1] if cy else 1 - f[:, 1])
                         * (f[:, 2] if cz else 1 - f[:, 2]))
                    acc = acc + tab[idx] * w[:, None]
        feats.append(acc)
    return torch.cat(feats, -1)


def sh3(d):
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([torch.full_like(x, _SH_C0), -_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x,
                        _SH_C2[0] * x * y, _SH_C2[1] * y * z, _SH_C2[2] * (2 * zz - xx - yy),
                        _SH_C2[3] * x * z, _SH_C2[4] * (xx - yy)], -1)


def chunk_loss(cfg: dict, params: dict, rays, grid, c2w, u, precision: str, n_march: int):
    """The loss of one microbatch of rays (the means over its rays)."""
    sc = float(cfg["sc_factor"])
    trunc = float(cfg["trunc"]) * sc
    rays_d = rays[:, RAY_DIR]
    fid = rays[:, RAY_FRAME_ID].long()
    depth = rays[:, RAY_DEPTH]
    dir_norm = torch.linalg.norm(rays_d, dim=-1)
    view = rays_d / dir_norm[:, None]
    tf = pose_corrections(params["pose_array"], cfg, fid) @ c2w[fid]
    dirs_w = torch.einsum("nij,nj->ni", tf[:, :3, :3], view)
    z, hit = sample_z(cfg, grid, tf[:, :3, 3].detach(), dirs_w.detach(), dir_norm, depth,
                      trunc, *u, n_march=n_march)
    N, S = z.shape
    pts = (torch.einsum("nij,nsj->nsi", tf[:, :3, :3], rays_d[:, None, :] * z[..., None])
           + tf[:, None, :3, 3]).reshape(-1, 3)
    valid = (pts.abs() <= 1.0).all(-1)
    emb = torch.where(valid[:, None], encode(pts, params["table"], cfg, precision), 0.0)
    sp, cp = params["sigma"], params["color"]
    h = torch.relu(emb @ sp["w0"] + sp["b0"]) @ sp["w1"] + sp["b1"]
    sdf, geo = h[:, 0], h[:, 1:]
    dirs = sh3(dirs_w)
    if "feature_array" in params:
        dirs = torch.cat([dirs, params["feature_array"][fid]], -1)
    c_in = torch.cat([dirs[:, None, :].expand(N, S, dirs.shape[-1]).reshape(N * S, -1), geo], -1)
    h = torch.relu(c_in @ cp["w0"] + cp["b0"])
    h = torch.relu(h @ cp["w1"] + cp["b1"])
    rgb = torch.sigmoid((h @ cp["w2"] + cp["b2"]).reshape(N, S, 3))
    sdf = sdf.reshape(N, S)
    vs = valid.reshape(N, S) & hit[:, None]

    lam = float(cfg["sdf_lambda"])
    neg = float(cfg["neg_trunc_ratio"])
    far = float(cfg["far"]) * sc
    d = depth[:, None]
    s = (d - z) / trunc
    w = torch.sigmoid(s * lam) * torch.sigmoid(-s * lam)
    band = (z - d <= trunc * neg) & (z - d >= -trunc)
    w = torch.where((depth > far)[:, None], 0.0, torch.where(band, w, 0.0))
    w = w / (w.sum(-1, keepdim=True) + 1e-10)
    w = torch.where(vs, w, 0.0)
    rgb_map = (w[..., None] * rgb).sum(-2)

    valid_rays = vs.any(-1) & (rays[:, RAY_TYPE] == 0)
    ray_w = torch.where(fid == 0, float(cfg["first_frame_weight"]), 1.0) * valid_rays.float()
    sample_w = ray_w[:, None] * vs.float()
    loss = float(cfg["rgb_weight"]) * torch.mean(
        (rgb_map - rays[:, RAY_RGB]) ** 2 * ray_w[:, None])
    near_ok = (d >= float(cfg["near"]) * sc) & (d <= far)
    front = z < d - trunc
    back = z > d + trunc * neg
    m_fs = (d > far) & (sdf < float(cfg["fs_sdf"]))
    fs = torch.mean(((sdf - float(cfg["fs_sdf"])) * m_fs) ** 2 * sample_w) * 0.5
    m_e = front & (d <= far) & (sdf < 1.0)
    fs = fs + torch.mean((sdf - 1.0).abs() * m_e * sample_w) * float(cfg["empty_weight"])
    m_s = ((~front) & (~back) & near_ok).float()
    sdf_l = torch.mean(((z + sdf * trunc) * m_s - d * m_s) ** 2 * sample_w) * 0.5
    loss = loss + fs * float(cfg["fs_weight"]) + sdf_l * float(cfg["trunc_weight"])
    if "feature_array" in params:
        loss = loss + float(cfg["feature_reg_weight"]) * torch.mean(params["feature_array"] ** 2)
    return loss


def n_march(cfg: dict, grid) -> int:
    """The march's probes a ray: twice the occupancy grid's resolution,
    at least 128."""
    return max(128, 2 * int(grid.shape[0]))


def train(cfg: dict, params: dict, adam: dict, rays, grid, c2w, draws: list,
          precision: str = "ref", microbatches: int = 1, drop_half: bool = False) -> dict:
    """Run one step per entry of ``draws`` (each (n_rays, batch_idx, (occ,
    band, fallback, importance))) from ``params`` (updated in place) and
    Adam's ``adam`` state {"count", "m": {name: tensor}, "v": {...}}
    (updated in place).  Returns each step's loss and, per leaf, the
    gradient Adam received in the first step.  ``drop_half`` is a planted
    fault: each microbatch's loss over its first half of rays alone."""
    if cfg["lrate_pose"] != cfg["lrate"]:
        raise ValueError("one learning rate for every leaf is the configuration here")
    leaves = [t for _, t in named_leaves(params)]
    names = [n for n, _ in named_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    march = n_march(cfg, grid)
    losses, first_grad = [], None
    with _matmul_precision(precision):
        for _, idx, u in draws:
            for t in leaves:
                t.grad = None
            batch = rays[idx]
            mb = len(batch) // microbatches
            total = 0.0
            for c in range(microbatches):
                sl = slice(c * mb, (c + 1) * mb)
                rows, uu = batch[sl], tuple(x[sl] for x in u[:3])
                if drop_half:
                    h = len(rows) // 2
                    rows, uu = rows[:h], tuple(x[:h] for x in uu)
                loss = chunk_loss(cfg, params, rows, grid, c2w, uu, precision, march)
                loss.backward()
                total += float(loss.detach())
            losses.append(total / microbatches)
            with torch.no_grad():
                grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
                if microbatches > 1:
                    grads = [g / microbatches for g in grads]
                gmax = torch.stack([g.abs().max() for g in grads]).max()
                scale = torch.clamp(float(cfg["gradient_max_norm"]) / (gmax + 1e-12), max=1.0)
                grads = [g * scale for g in grads]
                if first_grad is None:
                    first_grad = {n: g.clone() for n, g in zip(names, grads)}
                count = adam["count"]
                t_ = count + 1
                lr = float(cfg["lrate"]) * float(cfg["decay_rate"]) ** (
                    (count // 10) * 10 / int(cfg["n_step"]))
                for n, p, g in zip(names, leaves, grads):
                    m = adam["m"][n].mul_(B1).add_(g, alpha=1 - B1)
                    v = adam["v"][n].mul_(B2).addcmul_(g, g, value=1 - B2)
                    upd = (m / (1 - B1 ** t_)) / (torch.sqrt(v / (1 - B2 ** t_)) + ADAM_EPS)
                    p.add_(upd, alpha=-lr)
                adam["count"] = count + 1
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    return {"losses": losses, "first_grad": first_grad}


def fresh_adam(params: dict) -> dict:
    return {"count": 0, "m": {n: torch.zeros_like(t) for n, t in named_leaves(params)},
            "v": {n: torch.zeros_like(t) for n, t in named_leaves(params)}}
