"""``tracker_ms_per_frame``: the program's spans ``track/make_frame`` and
``track/process_new_frame`` (host clock; the tracker's work ends in a
readback) summed over the window, over its frames, in ms."""


def read(run):
    rec = run["record"]
    spans = rec.get("spans")
    if spans is None or not rec.get("frames"):
        return None
    total = sum(spans[k]["total_s"] for k in ("track/make_frame", "track/process_new_frame")
                if k in spans)
    return total * 1e3 / rec["frames"]
