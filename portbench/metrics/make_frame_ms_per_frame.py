"""``make_frame_ms_per_frame``: the program's span ``track/make_frame`` (the
host depth pipeline that builds a Frame: erode, two bilateral passes, xyz,
normals and edge filter; host clock) summed over the window, over its
frames, in ms."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("track/make_frame")
    if s is None or not rec.get("frames"):
        return None
    return s["total_s"] * 1e3 / rec["frames"]
