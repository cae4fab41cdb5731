"""``train_step_ms``: the whole window over the steps it completed (the
window closes with ``train_drain``), in ms."""


def read(run):
    rec = run["record"]
    if not rec.get("steps"):
        return None
    return rec["window_s"] * 1e3 / rec["steps"]
