"""``pairgen_ms_per_step``: the span ``loftr_train/make_batch`` (the pair
generator, closed by its readback, so its device work too) over the
window's steps, in ms."""


def read(run):
    rec = run["record"]
    span = (rec.get("spans") or {}).get("loftr_train/make_batch")
    if not span or not rec.get("steps"):
        return None
    return span["total_s"] * 1e3 / rec["steps"]
