"""The hard synthetic RGBD fixture of the quality evaluations: the port's
copy of ``tests/synthetic_hard.py`` (the JAX harness's fixture) in numpy,
scipy and host torch, with its PNGs written by ``io/png.py`` (the card's
machine has no OpenCV).  A non-convex textured union of spheres (the "blob") turns
through 90 degrees and more, a moving "finger" occludes it, and the depth
carries spatially correlated sensor noise; everything is analytic (the
ray-traced rendering, the ground-truth surface samples and the per-frame
poses).

The arrays it renders are bit-equal to the test fixture's, and the files it
writes decode equal to the cv2-written ones: the noise field's
``cv2.GaussianBlur`` is :func:`cv_gaussian_blur_sigma5`, which sums as
OpenCV 5 does in f64 (``tests/test_torch_eval_scripts.py`` holds both).

    python3 -m bundlesdf_tpu_torch.scripts.synth_hard OUT_DIR [--frames 14] [--deg 7]
"""
import argparse
import os

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ..io.png import write_png

# Blob skeleton: sphere centers/radii in the object frame (meters).
# Hand-picked to be non-convex (lobes + a protrusion) with ~0.22 m extent.
BLOB_SPHERES = np.array([
    # cx,     cy,     cz,     r
    [0.000,  0.000,  0.000, 0.075],
    [0.070,  0.020, -0.010, 0.055],
    [-0.065, 0.015,  0.020, 0.050],
    [0.010, -0.065,  0.010, 0.048],
    [0.000,  0.060, -0.040, 0.045],
    [-0.030, -0.020, -0.070, 0.042],
    [0.045,  0.045,  0.055, 0.040],
    [-0.050, -0.055, -0.030, 0.038],
], dtype=np.float64)


def _sphere_dot_texture(p_local, sid):
    """Deterministic dot texture from the hit point's position on its
    sphere: hash a fine integer lattice of the local direction."""
    d = p_local / np.maximum(np.linalg.norm(p_local, axis=-1, keepdims=True), 1e-9)
    i1 = np.floor(d[..., 0] * 40).astype(np.int64)
    i2 = np.floor(d[..., 1] * 40).astype(np.int64)
    i3 = np.floor(d[..., 2] * 40).astype(np.int64)
    hsh = (i1 * 73856093) ^ (i2 * 19349663) ^ (i3 * 83492791) ^ ((sid + 1) * 2654435761)
    return (hsh % 1000003).astype(np.float64) / 1000003.0


def render_blob_rgbd(ob_in_cam, K, H, W, spheres=BLOB_SPHERES, light=(0.3, -0.5, -0.8)):
    """Ray-trace the sphere union (CV camera, +z forward).

    Returns (rgb float [0,255], depth z in meters, mask uint8 {0,255})."""
    T_oc = np.linalg.inv(ob_in_cam)
    j, i = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d_cam = np.stack(
        [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
         np.ones_like(i, np.float64)], axis=-1)
    d_obj = d_cam @ T_oc[:3, :3].T            # unnormalized; t == z-depth
    o_obj = T_oc[:3, 3]

    t_best = np.full((H, W), np.inf)
    sid_best = np.full((H, W), -1, dtype=np.int64)
    a = np.sum(d_obj * d_obj, axis=-1)
    for s, (cx, cy, cz, r) in enumerate(spheres):
        oc = o_obj - np.array([cx, cy, cz])
        b = 2.0 * (d_obj @ oc)
        c = oc @ oc - r * r
        disc = b * b - 4 * a * c
        ok = disc > 0
        sq = np.sqrt(np.where(ok, disc, 0.0))
        t = (-b - sq) / (2 * a)
        ok &= t > 0.01
        closer = ok & (t < t_best)
        t_best = np.where(closer, t, t_best)
        sid_best = np.where(closer, s, sid_best)

    hit = sid_best >= 0
    t = np.where(hit, t_best, 0.0)
    p = o_obj + d_obj * t[..., None]

    # per-sphere base colors + dot texture + lambertian shading
    rng = np.random.default_rng(7)
    base = rng.uniform(60, 255, (len(spheres), 3))
    sid = np.maximum(sid_best, 0)
    rgb = base[sid]
    centers = spheres[:, :3][sid]
    radii = spheres[:, 3][sid]
    p_local = p - centers
    dots = _sphere_dot_texture(p_local, sid)
    rgb = rgb * (0.45 + 0.9 * dots[..., None])

    n_obj = p_local / np.maximum(radii[..., None], 1e-9)
    n_cam = n_obj @ ob_in_cam[:3, :3].T
    lv = np.asarray(light, np.float64)
    lv = lv / np.linalg.norm(lv)
    lam = np.clip(-(n_cam @ lv), 0.0, 1.0)
    rgb = rgb * (0.55 + 0.45 * lam[..., None])

    rgb = np.where(hit[..., None], np.clip(rgb, 0, 255), 0.0)
    depth = np.where(hit, t, 0.0)
    return rgb.astype(np.float32), depth.astype(np.float32), hit.astype(np.uint8) * 255


def render_finger(K, H, W, frame_idx, n_frames, depth_at=0.40):
    """A vertical 'finger' capsule sweeping across the view in front of the
    object (the HO3D hand stand-in).  Returns (occ mask bool, rgb, depth)."""
    phase = frame_idx / max(n_frames - 1, 1)
    # sweeps horizontally across the middle ~60% of the image, always present
    cx = W * (0.25 + 0.5 * (0.5 + 0.5 * np.sin(2 * np.pi * (phase * 0.75 + 0.1))))
    half_w = W * 0.035
    j, i = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    occ = (np.abs(i - cx) < half_w) & (j > H * 0.15)
    # cylinder-ish shading for some texture on the finger
    u = np.clip((i - cx) / half_w, -1, 1)
    shade = np.sqrt(np.maximum(1.0 - u * u, 0.0))
    rgb = np.stack([205 * (0.6 + 0.4 * shade),
                    160 * (0.6 + 0.4 * shade),
                    120 * (0.6 + 0.4 * shade)], axis=-1)
    depth = np.full((H, W), depth_at) + 0.01 * u
    return occ, rgb.astype(np.float32), depth.astype(np.float32)


def blob_surface_points(spheres=BLOB_SPHERES, n=4000, seed=0):
    """Uniform-ish samples of the UNION surface: sample each sphere's
    surface, reject points inside any other sphere (closed form)."""
    rng = np.random.default_rng(seed)
    areas = 4 * np.pi * spheres[:, 3] ** 2
    counts = np.maximum((n * areas / areas.sum()).astype(int), 8)
    pts = []
    for (cx, cy, cz, r), m in zip(spheres, counts):
        d = rng.normal(size=(m * 3, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        p = np.array([cx, cy, cz]) + r * d
        inside_other = np.zeros(len(p), bool)
        for (ox, oy, oz, orr) in spheres:
            if ox == cx and oy == cy and oz == cz and orr == r:
                continue
            inside_other |= np.linalg.norm(
                p - np.array([ox, oy, oz]), axis=-1) < orr - 1e-9
        p = p[~inside_other]
        pts.append(p[:m])
    return np.concatenate(pts)


def blob_surface_distance(q, spheres=BLOB_SPHERES):
    """Distance from query points to the union surface (exact outside,
    exact inside-single-sphere; the union SDF |min_i (|q-c_i|-r_i)| is the
    standard CSG-union distance — a tight bound near the surface)."""
    d = np.min(
        np.stack([np.linalg.norm(q - s[:3], axis=-1) - s[3] for s in spheres]),
        axis=0)
    return np.abs(d)


# cv2.getGaussianKernel(41, 5.0, cv2.CV_64F), half of it: OpenCV builds f64
# kernels with its own software exp (getGaussianKernelBitExact), which is up
# to 3 ulp from libm's, so the values are kept as they come out of it
_CV_KERNEL_SIGMA5_HALF = [float.fromhex(h) for h in (
    "0x1.c113e67a34f99p-16", "0x1.e9d347af7ba2bp-15", "0x1.00a91aed84200p-13",
    "0x1.026ceaaef5d9bp-12", "0x1.f3ffe5366298dp-12", "0x1.d0bb4c23b8d50p-11",
    "0x1.9f03a798bae23p-10", "0x1.64156b94ff93ap-9", "0x1.258a96c00a50bp-8",
    "0x1.d0fdc1a91a71bp-8", "0x1.61d971cc0d07ep-7", "0x1.02b6d98acd259p-6",
    "0x1.6b7adf708e819p-6", "0x1.eaa58a4ba7222p-6", "0x1.3e2acd55166d8p-5",
    "0x1.8c75f2fc165cap-5", "0x1.daa6517492b5fp-5", "0x1.10fd11517a7f6p-4",
    "0x1.2db2f1c27e702p-4", "0x1.405ae2f8a8257p-4", "0x1.46d39dcd3d08cp-4")]
CV_KERNEL_SIGMA5 = np.array(_CV_KERNEL_SIGMA5_HALF + _CV_KERNEL_SIGMA5_HALF[-2::-1])


def _reflect101(n: int, r: int) -> torch.Tensor:
    """OpenCV's BORDER_REFLECT_101 source index of p in [-r, n + r)."""
    out = []
    for p in range(-r, n + r):
        while n > 1 and (p < 0 or p >= n):
            p = -p if p < 0 else 2 * n - 2 - p
        out.append(p if n > 1 else 0)
    return torch.tensor(out)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b

    def split(x):
        c = 134217729.0 * x           # 2^27 + 1
        hi = c - (c - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``fma(a, b, c)`` of f64 tensors, correctly rounded: Boldo and
    Melquiond's emulation (the exact product's two parts added to ``c``,
    the low parts summed with rounding to odd).  Every step is one IEEE
    operation, which torch does not fuse."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    fix = (err != 0) & ((v.view(torch.int64) & 1) == 0)
    v = torch.where(fix, torch.nextafter(v, torch.where(err > 0, torch.inf, -torch.inf)), v)
    return th + v


def cv_gaussian_blur_sigma5(x: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(x, (0, 0), sigmaX=5.0)`` of an (H, W) f64 array,
    bit for bit as OpenCV 5 (AVX2 build) sums: the 41-tap row pass left to
    right with fused multiply-adds over the first ``W - W % 4`` columns
    (plain multiply-adds on the rest), then the column pass with the taps
    paired about the centre, ``s = k_0 x_0``, ``s += k_i (x_i + x_-i)``;
    reflect-101 borders.  Computed with torch on the host's cores."""
    k = CV_KERNEL_SIGMA5.tolist()
    r = len(k) // 2
    H, W = x.shape
    xp = torch.from_numpy(np.ascontiguousarray(x, np.float64))[:, _reflect101(W, r)]
    nf = W - W % 4
    fused, rest = xp[:, 0:nf] * k[0], xp[:, nf:W] * k[0]
    for t in range(1, len(k)):
        fused = _fma(xp[:, t:t + nf], k[t], fused)
        rest = rest + xp[:, nf + t:W + t] * k[t]
    yp = torch.cat([fused, rest], dim=1)[_reflect101(H, r), :]
    out = yp[r:r + H] * k[r]
    for i in range(1, r + 1):
        out = out + (yp[r + i:r + i + H] + yp[r - i:r - i + H]) * k[r + i]
    return out.numpy()


def make_hard_video(out_dir, n_frames=14, deg_step=7.0, H=480, W=480,
                    depth_noise=0.0015, depth_dropout=0.02, occluder=True,
                    seed=0):
    """Write the fixture in the YCBInEOAT layout (rgb/ depth/ masks/
    masks_hand/ cam_K.txt + gt_ob_in_cam.npy + gt_model_points.npy), as
    tests/synthetic_hard.py:147-209 does."""
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]], np.float32)
    axis = np.array([0.2, 1.0, 0.25])
    axis /= np.linalg.norm(axis)
    base = Rotation.from_euler("xyz", [15, 25, 8], degrees=True).as_matrix()
    for d in ["rgb", "depth", "masks", "masks_hand"]:
        os.makedirs(f"{out_dir}/{d}", exist_ok=True)
    np.savetxt(f"{out_dir}/cam_K.txt", K)
    gts = []
    for k in range(n_frames):
        R = Rotation.from_rotvec(axis * np.deg2rad(deg_step * k)).as_matrix() @ base
        ob_in_cam = np.eye(4)
        ob_in_cam[:3, :3] = R
        ob_in_cam[:3, 3] = [0.03 * np.sin(k * 0.5), 0.02 * np.cos(k * 0.4),
                            0.55 + 0.015 * np.sin(k * 0.3)]
        rgb, depth, mask = render_blob_rgbd(ob_in_cam, K, H, W)

        occ = np.zeros((H, W), bool)
        if occluder and k > 0:  # keep frame 0 clean for init
            occ, f_rgb, f_depth = render_finger(K, H, W, k, n_frames)
            infront = occ & ((depth == 0) | (f_depth < depth))
            rgb = np.where(infront[..., None], f_rgb, rgb)
            depth = np.where(infront, f_depth, depth)
            mask = np.where(infront, 0, mask)
            occ = infront

        # correlated sensor noise (~10 px), 2% dropout, mm quantization
        valid = depth > 0
        white = rng.normal(0, 1.0, depth.shape)
        corr = cv_gaussian_blur_sigma5(white)
        corr *= depth_noise / max(corr.std(), 1e-9)
        depth = depth + corr * valid
        drop = rng.uniform(size=depth.shape) < depth_dropout
        depth = np.where(drop, 0.0, depth)

        name = f"{k:05d}"
        write_png(f"{out_dir}/rgb/{name}.png", rgb.astype(np.uint8))
        write_png(f"{out_dir}/depth/{name}.png",
                  np.clip(depth * 1000, 0, 65535).astype(np.uint16))
        write_png(f"{out_dir}/masks/{name}.png", mask)
        write_png(f"{out_dir}/masks_hand/{name}.png", occ.astype(np.uint8) * 255)
        gts.append(ob_in_cam)
    np.save(f"{out_dir}/gt_ob_in_cam.npy", np.asarray(gts))
    np.save(f"{out_dir}/gt_model_points.npy", blob_surface_points())
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description="write the hard synthetic fixture")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--deg", type=float, default=7.0)
    args = ap.parse_args(argv)
    make_hard_video(args.out_dir, n_frames=args.frames, deg_step=args.deg)
    print("fixture:", args.out_dir)


if __name__ == "__main__":
    main()
