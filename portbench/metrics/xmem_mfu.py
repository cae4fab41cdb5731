"""``xmem_mfu``: the segmenter's FLOPs over the window (``xmem_costs``: the
key encoder and projections every frame, the decoder on every frame that
reads the memory, its sensory update on those that add no memory, the value
path on memory frames, similarity and dense readout at every element read;
from the counters ``xmem/frames``, ``xmem/mem_frames``,
``xmem/memory_elements`` and the span ``xmem/read_memory``'s count) over
the seconds of the span ``xmem/step`` (readback included) x the H100's 67
TFLOP/s of float32 outside the tensor cores (the segmenter runs in float32
with TF32 off), in %."""
from portbench import costs, xmem_costs


def read(run):
    spans = run["record"].get("spans") or {}
    need = ("xmem/step", "xmem/frames", "xmem/mem_frames", "xmem/read_memory",
            "xmem/memory_elements")
    if any(n not in spans for n in need) or spans["xmem/step"]["total_s"] <= 0:
        return None
    w = run["cfg"]["xmem"]
    t = run["traffic"]
    H, W = xmem_costs.frame_shape(int(t["height"]), int(t["width"]), int(w["size"]))
    frames = spans["xmem/frames"]["count"]
    reads = spans["xmem/read_memory"]["count"]
    mem = spans["xmem/mem_frames"]["count"]
    firsts = frames - reads                 # a session's first frame reads nothing
    updates = reads - (mem - firsts)        # reads on frames that add no memory
    flops = (frames * xmem_costs.key_flops(w, H, W)
             + updates * xmem_costs.decode_flops(w, H, W, True)
             + (reads - updates) * xmem_costs.decode_flops(w, H, W, False)
             + mem * xmem_costs.value_flops(w, H, W)
             + xmem_costs.read_flops(w, spans["xmem/memory_elements"]["count"], H, W))
    return 100.0 * flops / spans["xmem/step"]["total_s"] / costs.PEAK_F32_FLOPS
