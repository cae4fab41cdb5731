"""A copy of the benchmark under a temporary root with every configuration
and traffic cut to a size the CPU runs in seconds (the tracker needs the
480 x 640 frames to find its features; the videos are a few frames)."""
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_NOF = {"online": dict(N_rand=64, N_samples=8, N_samples_around_depth=8, num_levels=2,
                           finest_res=64, log2_hashmap_size=19, loop_chunk=2),
            "offline": dict(N_rand=64, N_samples=8, N_samples_around_depth=8, num_levels=3,
                            finest_res=64, log2_hashmap_size=15, loop_chunk=2,
                            micro_batch=32)}


def tiny_root(tmp, frames: int = 4, video_frames: int = 6) -> str:
    root = os.path.join(str(tmp), "root")
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for name, over in TINY_NOF.items():
        path = os.path.join(root, "portbench", "configs", f"{name}.json")
        cfg = json.load(open(path))
        cfg["nof"].update(over)
        json.dump(cfg, open(path, "w"))
    tdir = os.path.join(root, "portbench", "traffic")
    for t in os.listdir(tdir):
        d = json.load(open(os.path.join(tdir, t)))
        d["frames"] = frames if "use_nof" not in d else video_frames
        d["warm_frames"] = min(d.get("warm_frames", 0), video_frames)
        json.dump(d, open(os.path.join(tdir, t), "w"))
    return root
