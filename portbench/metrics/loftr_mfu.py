"""``loftr_mfu``: LoFTR's forward FLOPs over the real pairs the window
matched (``corres/pairs``; ``loftr_costs.pair_flops`` at the published
widths, the configuration's crop size and top-K) over the seconds of the
span ``corres/match`` x the H100's 67 TFLOP/s of float32 outside the tensor
cores (the engine runs in float32 with TF32 off), in %."""
from portbench import costs, loftr_costs
from portbench.reference.loftr import CVPR_DS


def read(run):
    spans = run["record"].get("spans") or {}
    pairs, match = spans.get("corres/pairs"), spans.get("corres/match")
    if not pairs or not match or match["total_s"] <= 0:
        return None
    fc = run["cfg"]["track"]["feature_corres"]
    size = int(fc["resize"])
    flops = pairs["count"] * loftr_costs.pair_flops(CVPR_DS, size, size,
                                                    int(fc["max_matches_per_pair"]))
    return 100.0 * flops / match["total_s"] / costs.PEAK_F32_FLOPS
