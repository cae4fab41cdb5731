"""``fuse_device_per_frame``: how many keyframes had their clouds fused on
the card (the program's counter ``nof/fuse_cloud_frames``: back-projection,
voxel downsample and the outlier test's neighbours in the kernels of
``csrc/fuse_cloud.cu``) over the window's frames; ~1.0 where every frame's
new keyframe was fused there, None where the program has no such counter."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("nof/fuse_cloud_frames")
    if s is None or not rec.get("frames"):
        return None
    return s["count"] / rec["frames"]
