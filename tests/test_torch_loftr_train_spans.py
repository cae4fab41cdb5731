"""The LoFTR trainer's spans and counters (``utils/profiler.py``): one step
records ``loftr_train/make_batch``, ``/forward`` (over the module's
``loftr/backbone``, ``loftr/coarse`` and ``loftr/fine``), ``/loss``,
``/backward`` and ``/optimizer``, and counts its pairs, its coarse labels'
positives and dropped cells, and its fine windows.

The narrow LoFTR of tests/test_torch_loftr.py on 64 x 64 pairs, on the
CPU."""
import pytest
import torch

from bundlesdf_tpu_torch.models import loftr as lt
from bundlesdf_tpu_torch.models import loftr_train as tlt
from bundlesdf_tpu_torch.utils import profiler

torch.set_num_threads(2)
NARROW = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=4)
GRID = 64


@pytest.mark.parametrize("max_gt,fine_gt", [(GRID, 12), (12, None)],
                         ids=["dense_labels_fine_gt", "capped_labels"])
def test_one_step_records_the_spans_and_counters(max_gt, fine_gt):
    tcfg = tlt.TrainCfg(H=64, W=64, batch=2, max_gt=max_gt, fine_gt=fine_gt)
    module = lt.init_weights(lt.LoftrModule(lt.LoftrCfg(**NARROW)), 0).train()
    step = tlt.make_train_step(module, tcfg,
                               tlt.LoftrOptimizer(tlt.trainable(module), tcfg, 10))
    draws = tlt.draw_pair(2, 64, 64, torch.Generator().manual_seed(3))
    n_valid = int(tlt.make_batch(2, 64, 64, GRID, draws).pos_mask.sum())
    profiler.enable(True)
    profiler.reset()
    batch = tlt.make_batch(2, 64, 64, max_gt, draws)
    step(batch, generator=torch.Generator().manual_seed(4))
    st = profiler.stats()
    for name in ("make_batch", "forward", "loss", "backward", "optimizer"):
        s = st[f"loftr_train/{name}"]
        assert s["count"] == 1 and s["total_s"] > 0 and s["parents"] == {None: 1}, name
    for name in ("loftr/backbone", "loftr/coarse", "loftr/fine"):
        assert st[name]["parents"] == {"loftr_train/forward": 1}, name
    assert st["loftr_train/forward"]["self_s"] < st["loftr_train/forward"]["total_s"]
    pos = int(batch.pos_mask.sum())
    assert st["loftr_train/pairs"]["count"] == 2
    assert st["loftr_train/gt_pos"]["count"] == pos
    assert st["loftr_train/gt_dropped"]["count"] == n_valid - pos
    assert st["loftr_train/fine_windows"]["count"] == 2 * (fine_gt or max_gt)
    if max_gt == GRID:
        assert pos == n_valid
    else:
        assert n_valid - pos > 0
