"""Scene-bound estimation: fuse masked depth into an object point cloud,
find the dominant cluster, and compute the normalization (translation +
scale) that maps the object into [-1,1]^3 (port of
``bundlesdf_tpu/io/scene_bounds.py``; reference tool.py:18-132).

Two routes fuse keyframes' clouds (``fuse_frame_clouds``), chosen by the
``device`` argument.  On a CUDA device the back-projection, the voxel
downsample and the outlier test's neighbour distances run as the kernels
of ``ops/fuse_cloud_cuda.py`` (``csrc/fuse_cloud.cu``), bit for bit the
host's, and the host keeps the outlier rule and the rigid transform; on the
CPU, or with no device, all of it is host numpy and scipy
(``fuse_frame_cloud``, which alone also averages colours), as in the JAX
module.  The fused cloud's downsample and the clustering stay on the host
on both routes.  The JAX module clusters
with sklearn's DBSCAN, which the port does without (``dbscan_labels``): a
point is a core point when at least ``min_samples`` points, itself
included, lie within ``eps``; clusters are the connected components of the
eps-graph of core points, numbered by their smallest member index as
sklearn's ``dbscan_inner`` numbers them; a non-core point within eps of a
core point takes the lowest such cluster number (the first cluster whose
search reaches it) and any other point is noise, -1.  At ``min_samples`` 1
(the shipped ``dbscan_eps_min_samples``) every point is a core point and
``cluster_labels`` is the faster path.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from ..ops import fuse_cloud_cuda
from ..utils.geometry import GLCAM_IN_CVCAM, depth_to_xyz_np

# fuse_frame_cloud's voxel size (m) and statistical outlier test
# (reference tool.py:52-55)
FUSE_VOXEL = 0.01
FUSE_NEIGHBORS = 30
FUSE_STD_RATIO = 2.0


def voxel_downsample(pts: np.ndarray, colors: np.ndarray | None, vox: float):
    """Average points (and colors) per voxel."""
    if len(pts) == 0:
        return pts, colors
    keys = np.floor(pts / vox).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    n = counts.shape[0]
    acc = np.zeros((n, 3))
    np.add.at(acc, inv, pts)
    out_pts = acc / counts[:, None]
    out_colors = None
    if colors is not None:
        accc = np.zeros((n, colors.shape[1]))
        np.add.at(accc, inv, colors)
        out_colors = accc / counts[:, None]
    return out_pts, out_colors


def remove_statistical_outliers(pts: np.ndarray, nb_neighbors: int = 30,
                                std_ratio: float = 2.0) -> np.ndarray:
    """open3d remove_statistical_outlier equivalent: keep points whose mean
    kNN distance is at most mean + std_ratio * std."""
    if len(pts) <= nb_neighbors:
        return np.ones(len(pts), dtype=bool)
    d, _ = cKDTree(pts).query(pts, k=nb_neighbors + 1, workers=-1)
    return outlier_keep(d, std_ratio)


def outlier_keep(d: np.ndarray, std_ratio: float) -> np.ndarray:
    """The outlier rule on ``d``, each point's distances to its nearest
    points ascending, itself first (``cKDTree.query``'s (n, k + 1))."""
    mean_d = d[:, 1:].mean(axis=1)
    thres = mean_d.mean() + std_ratio * mean_d.std()
    return mean_d <= thres


def cluster_labels(pts: np.ndarray, eps: float) -> np.ndarray:
    """DBSCAN labels at ``min_samples`` 1: the connected components of the
    eps-graph, numbered in the order of their smallest member index."""
    n = len(pts)
    pairs = cKDTree(pts).query_pairs(r=eps, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])),
                       shape=(n, n))
    n_comp, comp = connected_components(graph, directed=False)
    first = np.full(n_comp, n, dtype=np.int64)
    np.minimum.at(first, comp, np.arange(n))
    rank = np.empty(n_comp, dtype=np.int64)
    rank[np.argsort(first)] = np.arange(n_comp)
    return rank[comp]


def dbscan_labels(pts: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """sklearn ``DBSCAN(eps, min_samples).fit(pts).labels_``: core points
    have at least ``min_samples`` points within ``eps`` (distance <= eps,
    itself counted); clusters are the components of the core points'
    eps-graph, numbered in the order of their smallest core index; a border
    point takes the lowest-numbered cluster among its core neighbours;
    the rest are noise, -1."""
    n = len(pts)
    pairs = cKDTree(pts).query_pairs(r=eps, output_type="ndarray")
    a, b = pairs[:, 0], pairs[:, 1]
    core = (1 + np.bincount(a, minlength=n) + np.bincount(b, minlength=n)) >= min_samples
    both = core[a] & core[b]
    graph = coo_matrix((np.ones(int(both.sum()), np.int8), (a[both], b[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    labels = np.full(n, -1, dtype=np.int64)
    core_idx = np.flatnonzero(core)
    # number the core components by their first core point (index order)
    _, first = np.unique(comp[core_idx], return_index=True)
    rank = np.full(comp.max() + 1, -1, dtype=np.int64)
    rank[comp[core_idx[np.sort(first)]]] = np.arange(len(first))
    labels[core] = rank[comp[core]]
    # border points: the lowest cluster among their core neighbours
    big = np.iinfo(np.int64).max
    border = np.full(n, big, dtype=np.int64)
    for src, dst in ((a, b), (b, a)):
        sel = core[src] & ~core[dst]
        np.minimum.at(border, dst[sel], labels[src[sel]])
    has = border != big
    labels[has] = border[has]
    return labels


def find_biggest_cluster(pts: np.ndarray, eps: float = 0.06, min_samples: int = 1):
    """Reference tool.py:18-25: the points of the largest DBSCAN label (the
    lowest among equal sizes) and their mask.  As in the JAX function the
    noise label -1 takes part in the vote, so at ``min_samples`` > 1 the
    noise can be the "biggest cluster"."""
    if len(pts) == 0:
        raise ValueError(
            "scene-bounds: fused object cloud is empty — no keyframe had "
            "valid masked depth (check depth units/percentile filter/mask)"
        )
    if min_samples <= 1:
        labels = cluster_labels(pts, eps)
    else:
        labels = dbscan_labels(pts, eps, min_samples)
    ids, cnts = np.unique(labels, return_counts=True)
    keep = labels == ids[cnts.argmax()]
    return pts[keep], keep


def compute_translation_scales(pts: np.ndarray, max_dim: float = 2.0,
                               cluster: bool = True, eps: float = 0.06,
                               min_samples: int = 1):
    """Reference tool.py:28-39: center + scale into [-1,1] with 0.9 margin."""
    if cluster:
        pts, keep = find_biggest_cluster(pts, eps, min_samples)
    else:
        keep = np.ones(len(pts), dtype=bool)
    max_xyz = pts.max(axis=0)
    min_xyz = pts.min(axis=0)
    center = (max_xyz + min_xyz) / 2
    sc_factor = max_dim / (max_xyz - min_xyz).max() * 0.9
    return -center, float(sc_factor), keep


def fuse_frame_cloud(depth: np.ndarray, rgb: np.ndarray | None, mask: np.ndarray,
                     K: np.ndarray, glcam_in_world: np.ndarray):
    """Masked back-projection of one frame into world on the host (reference
    compute_scene_bounds_worker tool.py:42-64): (points, colours), (None,
    None) where no pixel is valid; ``rgb`` None gives no colours."""
    pts, colors = _frame_voxels(depth, rgb, mask, K)
    if pts is None:
        return None, None
    keep = remove_statistical_outliers(pts, FUSE_NEIGHBORS, FUSE_STD_RATIO)
    return _to_world(pts[keep], glcam_in_world), None if colors is None else colors[keep]


def fuse_frame_clouds(depths, masks, K: np.ndarray, glcam_in_worlds, device=None) -> list:
    """Each frame's world points, as ``fuse_frame_cloud`` gives them; None
    for a frame with no valid pixel.  On a CUDA ``device`` the frames go to
    the card in batches (``ops/fuse_cloud_cuda.py``), with the same bits,
    and a frame with a coordinate past ~10 km, or an inf depth, raises
    ``ValueError``; on any other device, or none, each frame runs
    ``fuse_frame_cloud``."""
    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        return [fuse_frame_cloud(d, None, m, K, g)[0]
                for d, m, g in zip(depths, masks, glcam_in_worlds)]
    voxels = fuse_cloud_cuda.frame_voxels(depths, masks, np.asarray(K, np.float32), dev,
                                          FUSE_VOXEL, FUSE_NEIGHBORS + 1)
    out = []
    for (pts, d), glcam_in_world in zip(voxels, glcam_in_worlds):
        if len(pts) == 0:
            out.append(None)
            continue
        keep = (np.ones(len(pts), dtype=bool) if len(pts) <= FUSE_NEIGHBORS
                else outlier_keep(d, FUSE_STD_RATIO))
        out.append(_to_world(pts[keep], glcam_in_world))
    return out


def _frame_voxels(depth, rgb, mask, K):
    """The host twin of the kernels' voxel means: (points, colours) of the
    frame's valid pixels, averaged per voxel; (None, None) where none is
    valid."""
    xyz = depth_to_xyz_np(np.asarray(depth, np.float32), np.asarray(K, np.float32))
    valid = (depth >= 0.1) & (mask > 0)
    pts = xyz[valid]
    if len(pts) == 0:
        return None, None
    colors = None if rgb is None else rgb[valid].reshape(-1, 3)
    return voxel_downsample(pts, colors, FUSE_VOXEL)


def _to_world(pts: np.ndarray, glcam_in_world: np.ndarray) -> np.ndarray:
    cam_in_world = glcam_in_world @ GLCAM_IN_CVCAM  # CV cam -> world
    return pts @ cam_in_world[:3, :3].T + cam_in_world[:3, 3]


def compute_scene_bounds(rgbs, depths, masks, K, glcam_in_worlds,
                         eps: float = 0.06, min_samples: int = 1,
                         translation=None, sc_factor=None, device=None):
    """Reference tool.py:67-132.  Returns (sc_factor, translation,
    pcd_real_scale pts, pcd_normalized pts).  ``device`` routes the
    frames' fusion (``fuse_frame_clouds``); ``rgbs`` is not read."""
    clouds = fuse_frame_clouds(depths, masks, K, glcam_in_worlds, device)
    all_pts = [pts for pts in clouds if pts is not None]
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3))
    pts, _ = voxel_downsample(pts, None, eps / 5)

    if translation is None:
        translation, sc_factor, keep = compute_translation_scales(
            pts, cluster=True, eps=eps, min_samples=min_samples
        )
    else:
        tmp = (pts + translation) * sc_factor
        keep = (np.abs(tmp) < 1).all(axis=-1)
    pts_real = pts[keep]
    pts_norm = (pts_real + translation) * sc_factor
    return sc_factor, np.asarray(translation, dtype=np.float64), pts_real, pts_norm
