"""The spread of the LoFTR trainer's loss curve on the CUDA card (not a test:
pytest does not collect this file).

    python3 tests/port_loftr_train_probe.py [OUT.json] [--steps 100,200] [--runs 4]
        [--perturb] [--deterministic]

``train_loftr`` at ``TrainCfg()`` from the seeded init (seed 0), ``--runs``
times for each step count in ``--steps``.  The batches are the same in every
run (a device generator seeded with 0); the runs differ only by the card's
non-deterministic reductions.  For each run it prints the mean loss of the
first and last 20 steps (``chip_smoke.py``'s ``loftr_train`` check), their
medians, the largest step loss with its coarse and fine parts, and the mean
loss over 8 fixed held-out batches (a generator seeded with 1234) of the init
and of the trained weights, and whether its curve equals the first run's of
its step count bit for bit.  ``--deterministic``: every run under
``torch.use_deterministic_algorithms``, as ``chip_smoke.py`` trains.  Writes
every curve to OUT.json when it is given.
"""
import argparse
import contextlib
import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bundlesdf_tpu_torch.models import loftr  # noqa: E402
from bundlesdf_tpu_torch.models import loftr_train as lt  # noqa: E402

WINDOW = 20


def held_out_loss(module, tcfg, batches) -> float:
    loss_fn = lt.make_loss_fn(module, tcfg)
    with torch.no_grad():
        return float(np.mean([float(loss_fn(b)[0]) for b in batches]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="")
    ap.add_argument("--steps", default="100,200")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--perturb", action="store_true",
                    help="before each run, hold a block of device memory of a "
                         "size drawn from the run's index, so that the runs' "
                         "tensors sit at other addresses")
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tcfg = lt.TrainCfg()
    gen = torch.Generator(device=dev).manual_seed(1234)
    held = [lt.make_batch(tcfg.batch, tcfg.H, tcfg.W, tcfg.max_gt, generator=gen, device=dev)
            for _ in range(8)]
    init = loftr.init_weights(loftr.LoftrModule(), seed=0).to(dev).train()
    init_held = held_out_loss(init, tcfg, held)
    del init
    rows = []
    for n in (int(s) for s in args.steps.split(",")):
        first = None
        for r in range(args.runs):
            pad = None
            if args.perturb:
                mb = int(np.random.default_rng(1000 * n + r).integers(1, 2048))
                pad = torch.empty(mb << 18, device=dev)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                module, hist = lt.train_loftr(tcfg=tcfg, n_steps=n, seed=0, log_every=1)
            s = time.perf_counter() - t0
            loss = np.array([h["loss"] for h in hist])
            first = loss if first is None else first
            k = int(np.argmax(loss))
            row = {"steps": n, "run": r, "first_mean": float(loss[:WINDOW].mean()),
                   "last_mean": float(loss[-WINDOW:].mean()),
                   "first_median": float(np.median(loss[:WINDOW])),
                   "last_median": float(np.median(loss[-WINDOW:])),
                   "max_step": k, "max_loss": float(loss[k]),
                   "max_coarse": hist[k]["coarse"], "max_fine": hist[k]["fine"],
                   "held_out_init": init_held,
                   "held_out_trained": held_out_loss(module, tcfg, held),
                   "equals_first_run": bool(np.array_equal(loss, first)), "train_s": s,
                   "curve": [[h["loss"], h["coarse"], h["fine"]] for h in hist]}
            rows.append(row)
            print(json.dumps({k: v for k, v in row.items() if k != "curve"}), flush=True)
            del module, pad
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": torch.cuda.get_device_name(0), "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
