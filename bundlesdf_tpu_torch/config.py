"""Configuration: the tracker and Neural Object Field (NOF) config families.

The port's own copy of ``Cfg``, the three tracker configs
(``default_track_config``, ``ycbineoat_track_config``,
``behave_track_config``) and ``default_nof_config`` from the JAX package
(``bundlesdf_tpu/config.py``), with the same keys and values, so the port
never imports the JAX package.  Mirrors the reference
BundleTrack/config_{ho3d,ycbineoat,behave}.yml and config.yml:1-103.
Runs mutate a copy and may dump it next to their outputs (config as
artifact), so later stages reload exactly what was used.
"""
from __future__ import annotations

import copy


class Cfg(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(d):
        if isinstance(d, dict):
            return Cfg({k: Cfg.wrap(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Cfg.wrap(v) for v in d]
        return d

    def merged(self, other: dict) -> "Cfg":
        out = copy.deepcopy(self)
        _deep_update(out, other)
        return Cfg.wrap(out)

    def save(self, path: str):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(_plain(self), f, sort_keys=False)

    @staticmethod
    def load(path: str) -> "Cfg":
        import yaml

        with open(path) as f:
            return Cfg.wrap(yaml.safe_load(f))


def _deep_update(base: dict, upd: dict):
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_plain(v) for v in d]
    return d


def default_track_config() -> Cfg:
    """Tracker config defaults (reference BundleTrack/config_ho3d.yml:1-113)."""
    return Cfg.wrap(
        {
            "debug_dir": "/tmp/bundlesdf_tpu",
            "SPDLOG": 1,
            "downscale": 1,
            "depth_processing": {
                "zfar": 1.0,
                "erode": {"radius": 1, "diff": 0.001, "ratio": 0.8},
                "bilateral_filter": {"radius": 2, "sigma_D": 2.0, "sigma_R": 100000.0},
                "outlier_removal": {"num": 30, "std_mul": 3.0},
                "edge_normal_thres": 10.0,
                "denoise_cloud": False,
                "percentile": 95,
            },
            "visible_angle": 70.0,
            "bundle": {
                "num_iter_outter": 7,
                "num_iter_inner": 5,
                "window_size": 5,
                "max_BA_frames": 10,
                "subset_selection_method": "normal_orientation_nearest",
                "depth_association_radius": 5,
                "non_neighbor_max_rot": 90.0,
                "non_neighbor_min_visible": 0.1,
                "icp_pose_rot_thres": 60.0,
                "w_p2p": 1.0,
                "w_fm": 1.0,
                "robust_delta": 0.005,
                "min_fm_edges_newframe": 15,
                "image_downscale": 4,
                "feature_edge_dist_thres": 0.01,
                "feature_edge_normal_thres": 30.0,
                "max_optimized_feature_loss": 0.03,
                # fused_ba: run fresh BA-pair matching + the BA solve as ONE
                # device program with one packed readback
                # (ops/fused_track.py); falls back to the split
                # find_corres + optimize path when ineligible.
                "fused_ba": True,
                # fresh-pair capacity of the fused program (one compiled
                # shape; larger batches fall back to the split path)
                "fused_ba_pairs": 12,
                "fused_host_edge_cap": 8192,
            },
            "keyframe": {
                "min_interval": 1,
                "min_feat_num": 0,
                "min_trans": 0.0,
                "min_rot": 5.0,
                "min_visible": 1.0,
            },
            "feature_corres": {
                "mutual": True,
                "max_dist_neighbor": 0.02,
                "max_normal_neighbor": 30.0,
                "min_match_with_ref": 5,
                "resize": 400,
                "rematch_after_nerf": False,
                "max_matches_per_pair": 512,
                # matching engine: corner | sift | loftr | remote
                # (reference uses the GluNet/LoFTR path, Bundler.cpp:51 +
                # loftr_wrapper.py; `corner` is the weight-free default)
                "matcher": "corner",
                # for matcher=loftr: torch .ckpt (outdoor_ds.ckpt-style) or
                # converted .npz params; empty = random-init weights
                "loftr_ckpt": "",
                # for matcher=remote: ZMQ matcher server port (reference
                # Lfnet/DeepOpticalFlow servers, FeatureManager.cpp:2080-2430)
                "remote_port": 5555,
            },
            "ransac": {
                "max_iter": 2000,
                "num_sample": 3,
                "inlier_dist": 0.005,
                "inlier_normal_angle": 30.0,
                "max_trans_neighbor": 0.02,
                "max_rot_deg_neighbor": 30.0,
                "max_trans_no_neighbor": 0.1,
                "max_rot_no_neighbor": 60.0,
                "min_match_after_ransac": 5,
            },
            "p2p": {"projective": False, "max_dist": 0.01, "max_normal_angle": 20.0},
            "pool": {
                "max_keyframes": 128,
                "max_frames": 16,
            },
        }
    )


def ycbineoat_track_config() -> Cfg:
    """YCBInEOAT tracker variant (reference config_ycbineoat.yml diff vs ho3d):
    deeper z range, looser match/RANSAC gates for neighbors but tight
    non-neighbor caps (robot-arm manipulation has smooth motion between
    non-neighbors too)."""
    return default_track_config().merged(
        {
            "depth_processing": {"zfar": 2.0, "outlier_removal": {"std_mul": 1.0},
                                 "percentile": 100},
            "bundle": {"non_neighbor_max_rot": 180.0, "icp_pose_rot_thres": 180.0},
            "feature_corres": {
                "max_dist_neighbor": 0.03,
                "max_normal_neighbor": 45.0,
                "max_dist_no_neighbor": 0.02,
                "max_normal_no_neighbor": 45.0,
            },
            "ransac": {
                "inlier_dist": 0.015,
                "inlier_normal_angle": 45.0,
                "max_trans_neighbor": 0.03,
                "max_trans_no_neighbor": 0.02,
                "max_rot_no_neighbor": 10.0,
            },
            "p2p": {"max_dist": 0.02, "max_normal_angle": 45.0},
        }
    )


def behave_track_config() -> Cfg:
    """BEHAVE tracker variant (reference config_behave.yml diff vs ho3d):
    human-scale scenes — 3x image downscale, far plane 3.5 m, much looser
    distance gates (larger objects, coarser depth)."""
    return default_track_config().merged(
        {
            "downscale": 3,
            "depth_processing": {"zfar": 3.5},
            "bundle": {"max_optimized_feature_loss": 0.05},
            "feature_corres": {"max_dist_neighbor": 0.1, "min_match_with_ref": 15},
            "ransac": {
                "inlier_dist": 0.01,
                "inlier_normal_angle": 20.0,
                "max_trans_neighbor": 0.1,
            },
            "p2p": {"max_dist": 0.02, "max_normal_angle": 45.0},
        }
    )

def default_nof_config() -> Cfg:
    """Neural-object-field config defaults (reference config.yml:1-103)."""
    return Cfg.wrap(
        {
            "n_step": 500,
            "N_rand": 2048,
            "lrate": 0.01,
            "lrate_pose": 0.01,
            "decay_rate": 0.1,
            "N_samples": 128,
            "N_samples_around_depth": 64,
            "N_importance": 0,
            "perturb": 1,
            "feature_grid_dim": 2,
            "gradient_max_norm": 0.1,
            "finest_res": 128,
            "base_res": 16,
            "num_levels": 4,
            "log2_hashmap_size": 22,
            # Encoder knobs (no reference equivalent; names kept from the
            # JAX package, see ops/hashgrid.py resolve_scatter/resolve_reduce):
            # hash_layout: cell|exact;
            # hash_scatter: auto|xla|pallas|seg — 'auto' resolves to 'xla'
            # (index_add_; the JAX package resolves it to 'seg', a choice
            # made on the TPU's costs and not yet timed on the card);
            # 'pallas' names the hand-written CUDA fused scatter
            # (ops/hashgrid_cuda.py) for the small dense levels; 'seg' runs
            # JAX's segment-dedup scatters and two-stage run gathers.
            "hash_layout": "cell",
            "hash_scatter": "auto",
            # bf16 staging of the big dense levels' corner cache / grad
            # cache (table weights + Adam state stay f32; see
            # HashGridSpec.big_dtype).
            "hash_big_dtype": "bfloat16",
            # cache-grad reduce for the bf16-staged big levels: 'auto'
            # resolves to 'pallas' — the hand-written CUDA reduce
            # (ops/reduce_cuda.py) — for CUDA tensors, 'conv' (plain torch)
            # otherwise.
            "hash_reduce": "auto",
            "n_train_image": 300,
            "use_octree": 1,
            "first_frame_weight": 10.0,
            "denoise_depth_use_octree_cloud": True,
            "octree_smallest_voxel_size": 0.02,
            "octree_raytracing_voxel_size": 0.02,
            "octree_dilate_size": 0.02,
            "down_scale_ratio": 1,
            "bounding_box": [[-1, -1, -1], [1, 1, 1]],
            "use_mask": 1,
            "dilate_mask_size": 0,
            "rays_valid_depth_only": True,
            "near": 0.1,
            "far": 2.0,
            "rgb_weight": 10.0,
            "depth_weight": 0.0,
            "trunc": 0.01,
            "trunc_start": 0.01,
            "sdf_lambda": 5.0,
            "neg_trunc_ratio": 1.0,
            "trunc_decay_type": "",
            "fs_weight": 100.0,
            "empty_weight": 0.01,
            "fs_rgb_weight": 0.0,
            "trunc_weight": 6000.0,
            "frame_features": 0,
            "optimize_poses": 1,
            "pose_reg_weight": 0.0,
            "feature_reg_weight": 0.1,
            "mode": "sdf",
            "fs_sdf": 0.001,
            "mesh_resolution": 0.005,
            "max_trans": 0.02,
            "max_rot": 20.0,
            "continual": True,
            "dbscan_eps": 0.06,
            "dbscan_eps_min_samples": 1,
            "sync_max_delay": 0,
            # n_step_extend: step budget of CONTINUAL extension rounds
            # (0 = use n_step).  The reference retrains from scratch every
            # round (add_new_frames(reuse_weights=False) -> create_nerf,
            # nerf_runner.py:350-380), so it needs the full n_step each
            # time; a continual runner keeping its weights can refine with
            # fewer steps per round (quality gated by EVAL_synth.json).
            "n_step_extend": 0,
            # nof_queue_depth: max NOF loop-chunks kept queued on the
            # device by the scheduler's pump — bounds how long a tracker
            # launch can wait behind NOF work while keeping the device fed
            # during host tracking.
            "nof_queue_depth": 2,
            # calibrate_step: one-time per-step device-time measurement at
            # the first round completion (feeds overlap_frac accounting);
            # its steps are deducted from the next round's budget.
            "calibrate_step": True,
            "sc_factor": 1.0,
            "translation": [0.0, 0.0, 0.0],
            "multires_views": 3,
            "i_embed": 1,
            "i_embed_views": 2,
            "amp": True,
            "netdepth": 3,
            "netwidth": 64,
            "start_nerf_keyframes": 5,
            "ray_pool_reserve_log2": 0,
            "ray_pool_max_log2": 23,
            # loop_chunk: steps per compiled scan launch.  Small chunks are
            # the overlap quantum: a tracker launch queues behind at most
            # nof_queue_depth x loop_chunk steps (~0.5 s/chunk at 16 x
            # 30 ms), while the scan still amortizes the dispatch RTT.
            "loop_chunk": 16,
            # i_weights cadence writes a resumable (full=True) checkpoint
            "ckpt_full": False,
            "max_kf_pool": 300,
            "save_dir": "/tmp/bundlesdf_tpu_nof",
        }
    )
