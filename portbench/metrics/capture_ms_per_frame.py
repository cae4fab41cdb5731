"""``capture_ms_per_frame``: the program's span ``nof/capture`` (the NOF
step captured as a CUDA graph again, as a new runner or a new ray pool
asks; host clock) summed over the window, over its frames, in ms; 0 where
the NOF trained in the window (``nof/train_advance``) and captured
nothing."""


def read(run):
    rec = run["record"]
    spans = rec.get("spans") or {}
    if not rec.get("frames") or ("nof/capture" not in spans
                                 and "nof/train_advance" not in spans):
        return None
    s = spans.get("nof/capture")
    return 0.0 if s is None else s["total_s"] * 1e3 / rec["frames"]
