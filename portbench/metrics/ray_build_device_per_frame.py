"""``ray_build_device_per_frame``: how many keyframes had their NOF rays
built on the card (the program's counter ``nof/build_rays_device_frames``:
pixel selection, box clip, occupancy cull and cloud denoise in the kernels
of ``csrc/build_rays.cu``) over the window's frames; ~1.0 where every
frame's new keyframe was built there, None where the program has no such
counter."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("nof/build_rays_device_frames")
    if s is None or not rec.get("frames"):
        return None
    return s["count"] / rec["frames"]
