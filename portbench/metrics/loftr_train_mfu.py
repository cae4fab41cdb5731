"""``loftr_train_mfu``: a step's FLOPs (``loftr_train_costs.step_flops``:
each pair's forward and backward at the configuration's widths,
resolution and fine capacity, times the batch) over ``train_step_ms`` x the
H100's 67 TFLOP/s of float32 outside the tensor cores (the trainer runs in
float32 with TF32 off), in %."""
from portbench import costs, loftr_train_costs
from portbench.reference.loftr import CVPR_DS


def read(run):
    rec = run["record"]
    cfg = run["cfg"]
    if run["trace"] is None or not rec.get("steps") or "train" not in cfg:
        return None
    t = cfg["train"]
    w = {k: cfg["loftr"][k] for k in CVPR_DS}
    flops = int(t["batch"]) * loftr_train_costs.step_flops(w, int(t["H"]), int(t["W"]),
                                                           int(t["fine_gt"]))
    step_s = rec["window_s"] / rec["steps"]
    return 100.0 * flops / step_s / costs.PEAK_F32_FLOPS
