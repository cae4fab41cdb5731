"""Matcher quality on the hard synthetic fixture (port of
``scripts/eval_matcher.py``).

A matching engine is scored the way the tracker consumes it: each frame pair
is warped and cropped with ``process_image_pair`` as in ``find_corres``, the
engine predicts matches in crop space, the matches are unwarped to
full-resolution pixels, and each is checked against the fixture's geometry:
frame A's depth at uvA is lifted to 3D, moved by the ground-truth relative
pose, projected into frame B and compared with uvB (:func:`gt_error_px`).

Per engine it reports matches a pair, the inlier rates at 3 and 5 px and
the mean pixel error of the inliers, under the JAX script's keys.  Engines:
``corner`` (the built-in matcher), ``sift``, ``loftr`` (``--loftr_ckpt``,
else seeded random weights) and ``remote`` (a ``MatchServer`` on
``feature_corres.remote_port``, which the fixture's ``track_config.yml``
may set).

    python3 -m bundlesdf_tpu_torch.scripts.eval_matcher --video VIDEO \\
        [--matchers corner,sift] [--loftr_ckpt FILE] [--gaps 1,2,4] \\
        [--max_pairs 24] [--out FILE.json] [--device cpu]

Make a fixture with ``python3 -m bundlesdf_tpu_torch.scripts.synth_hard``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..config import Cfg, ycbineoat_track_config
from ..io.readers import YcbineoatReader
from ..models import matcher as matcher_mod
from ..tracking.corres import _apply_homography, make_matcher, process_image_pair
from ..tracking.frame import Frame
from ..utils.device import resolve_device


def build_frames(video_dir, ids, cfg):
    """Frames ``ids`` of the fixture at their ground-truth poses."""
    reader = YcbineoatReader(video_dir, prefetch=False)
    gts = np.load(os.path.join(video_dir, "gt_ob_in_cam.npy"))
    frames = {}
    for i in ids:
        frames[i] = Frame(reader.get_color(i), reader.get_depth(i), reader.K, i, f"{i:05d}",
                          cfg, pose_in_model=np.linalg.inv(gts[i]).astype(np.float32),
                          fg_mask=reader.get_mask(i) > 0)
    return frames, gts, reader.K


def gt_error_px(fa, fb, gtA, gtB, K, uvA, uvB):
    """Per-match reprojection error of uvA (frame A px) into frame B under
    the ground-truth relative pose, against the predicted uvB; +inf where
    uvA lands on invalid depth (JAX eval_matcher.py:50-68)."""
    h, w = fa.depth.shape
    ui = np.clip(np.round(uvA[:, 0]).astype(int), 0, w - 1)
    vi = np.clip(np.round(uvA[:, 1]).astype(int), 0, h - 1)
    z = fa.depth[vi, ui]
    ok = z > 0.01
    x = (uvA[:, 0] - K[0, 2]) / K[0, 0] * z
    y = (uvA[:, 1] - K[1, 2]) / K[1, 1] * z
    pA = np.stack([x, y, z, np.ones_like(z)], -1)
    pB = (gtB @ np.linalg.inv(gtA) @ pA.T).T
    u = pB[:, 0] / pB[:, 2] * K[0, 0] + K[0, 2]
    v = pB[:, 1] / pB[:, 2] * K[1, 1] + K[1, 2]
    err = np.hypot(u - uvB[:, 0], v - uvB[:, 1])
    return np.where(ok, err, np.inf)


def run_matcher(name, pairs, cfg, loftr_ckpt="", device=None, chunk=4):
    """(uvA, uvB) full-resolution matches of each pair through the
    ``find_corres`` crop path; the engines other than ``corner`` predict
    ``chunk`` pairs a call."""
    dev = resolve_device(device)
    out_size = int(cfg["feature_corres"]["resize"])
    crops = [process_image_pair(fa, fb, out_size, device=dev) for fa, fb in pairs]
    imgsA = torch.stack([c[0] for c in crops])
    imgsB = torch.stack([c[1] for c in crops])
    if name == "corner":
        mcfg = matcher_mod.CornerMatcherCfg(
            max_matches=int(cfg["feature_corres"]["max_matches_per_pair"]))
        res = matcher_mod.match_pairs_batched(imgsA, imgsB, mcfg)
        corres_b, valid_b = res["corres"].cpu().numpy(), res["valid"].cpu().numpy()
    else:
        cfg2 = Cfg.wrap({"feature_corres": dict(cfg["feature_corres"], matcher=name)})
        if loftr_ckpt:
            cfg2["feature_corres"]["loftr_ckpt"] = loftr_ckpt
        eng = make_matcher(cfg2, device=dev)
        cbs, vbs = [], []
        for s in range(0, len(pairs), chunk):
            cb, vb = eng.predict(imgsA[s:s + chunk], imgsB[s:s + chunk])
            cbs.append(np.asarray(cb.cpu() if torch.is_tensor(cb) else cb))
            vbs.append(np.asarray(vb.cpu() if torch.is_tensor(vb) else vb))
        corres_b, valid_b = np.concatenate(cbs), np.concatenate(vbs)
    out = []
    for i in range(len(pairs)):
        cc = np.asarray(corres_b[i], np.float64)[np.asarray(valid_b[i], bool)]
        _, _, ta, tb = crops[i]
        out.append((_apply_homography(np.linalg.inv(ta), cc[:, 0:2]),
                    _apply_homography(np.linalg.inv(tb), cc[:, 2:4])))
    return out


def pair_ids_for(n: int, gaps, max_pairs: int):
    """The scored pairs (i + g, i) of an n-frame video (JAX
    eval_matcher.py:162-167)."""
    pair_ids = []
    for g in gaps:
        pair_ids += [(i + g, i) for i in range(0, n - g,
                                               max(1, (n - g) * len(gaps) // max_pairs))]
    return pair_ids


def score(matches, pair_ids, frames, gts, K) -> dict:
    """The report of one engine (JAX eval_matcher.py:175-190)."""
    errs, counts = [], []
    for (uvA, uvB), (ia, ib) in zip(matches, pair_ids):
        e = gt_error_px(frames[ia], frames[ib], gts[ia], gts[ib], K, uvA, uvB)
        errs.append(e)
        counts.append(len(e))
    e = np.concatenate(errs) if errs else np.array([])
    fin = e[np.isfinite(e)]
    return {
        "matches_per_pair": round(float(np.mean(counts)), 1),
        "inlier_rate_3px": round(float((fin < 3).mean()), 4) if len(fin) else 0.0,
        "inlier_rate_5px": round(float((fin < 5).mean()), 4) if len(fin) else 0.0,
        "mean_err_inliers_px": (round(float(fin[fin < 5].mean()), 3)
                                if (fin < 5).any() else None),
        "n_valid_depth": int(len(fin)),
    }


def load_track_config(video_dir) -> Cfg:
    """The YCBInEOAT tracker config, with the fixture's ``track_config.yml``
    merged over it when there is one."""
    cfg = ycbineoat_track_config()
    ds_cfg = os.path.join(video_dir, "track_config.yml")
    if os.path.exists(ds_cfg):
        for k, v in (Cfg.load(ds_cfg) or {}).items():
            if isinstance(v, dict) and k in cfg:
                cfg[k].update(v)
            else:
                cfg[k] = v
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="matcher quality on the hard fixture")
    ap.add_argument("--video", default=os.path.join(tempfile.gettempdir(), "synth_hard",
                                                    "video"),
                    help="a hard-fixture video (default: benchmark_synth's)")
    ap.add_argument("--matchers", default="corner,sift")
    ap.add_argument("--loftr_ckpt", default="")
    ap.add_argument("--gaps", default="1,2,4")
    ap.add_argument("--max_pairs", type=int, default=24)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = load_track_config(args.video)
    gaps = [int(g) for g in args.gaps.split(",")]
    n = len(os.listdir(os.path.join(args.video, "rgb")))
    pair_ids = pair_ids_for(n, gaps, args.max_pairs)
    ids = sorted({i for p in pair_ids for i in p})
    frames, gts, K = build_frames(args.video, ids, cfg)
    pairs = [(frames[a], frames[b]) for a, b in pair_ids]

    report = {"video": args.video, "n_pairs": len(pairs), "gaps": gaps}
    for name in [m.strip() for m in args.matchers.split(",") if m.strip()]:
        matches = run_matcher(name, pairs, cfg, loftr_ckpt=args.loftr_ckpt,
                              device=args.device)
        report[name] = score(matches, pair_ids, frames, gts, K)
        print(name, json.dumps(report[name]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
