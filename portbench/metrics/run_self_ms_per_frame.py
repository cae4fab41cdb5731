"""``run_self_ms_per_frame``: the self time of the program's root span
``pipeline/run`` (a frame's ``BundleSdf.run`` less the time its child spans
cover: the part of a frame that no span names; host clock) summed over the
window, over its frames, in ms."""


def read(run):
    rec = run["record"]
    s = (rec.get("spans") or {}).get("pipeline/run")
    if s is None or "self_s" not in s or not rec.get("frames"):
        return None
    return s["self_s"] * 1e3 / rec["frames"]
