"""``fuse_cluster_ms_per_frame``: the program's span ``nof/fuse_cluster`` (a
NOF round's host cloud work: the new keyframes' clouds fused, a voxel
downsample and DBSCAN's biggest cluster; host clock) summed over the
window, over its frames, in ms."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("nof/fuse_cluster")
    if s is None or not rec.get("frames"):
        return None
    return s["total_s"] * 1e3 / rec["frames"]
