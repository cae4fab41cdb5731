"""``train_mfu``: the step's model FLOPs (the two MLPs' GEMMs, forward and
twice that backward, over every sample of the batch; ``costs.py``) over
``train_step_ms`` x the H100's 67 TFLOP/s of float32 outside the tensor
cores (the GEMMs run in float32 with TF32 off), in %."""
from portbench import costs


def read(run):
    rec = run["record"]
    if run["trace"] is None or not rec.get("steps"):
        return None
    step_s = rec["window_s"] / rec["steps"]
    return 100.0 * costs.step_model_flops(run["cfg"]["nof"]) / step_s / costs.PEAK_F32_FLOPS
