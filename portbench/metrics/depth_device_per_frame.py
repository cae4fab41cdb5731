"""``depth_device_per_frame``: how many Frames built their depth maps on the
card (the count of the program's span ``track/depth/device``: upload, one
kernel launch, readback) over the window's frames; 1.0 where every frame's
depth pipeline ran as the kernel, None where no frame did."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("track/depth/device")
    if s is None or not rec.get("frames"):
        return None
    return s["count"] / rec["frames"]
