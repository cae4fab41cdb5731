"""XMem (``models/xmem.py``, ``io/segmentation.py::XmemSegmenter``) against
the plain reference (``portbench/reference/xmem.py``) on the CPU, at the
published widths on 64 x 96 frames, on one set of seeded weights drawn by
the reference and loaded into the program.

Module by module (the key encoder and projection, the value encoder with
its deep update, the decoder with and without its sensory update, the
memory read with tied similarities) within float32 summing orders; a whole
session under a shrunk schedule (``mem_every`` 1, T_min 2, T_max 3, LT_max
48, P 8), in which consolidation and eviction both happen, teacher-forced
(each reference step from the program's own state) with its bookkeeping
exact; frames resized and padded; the pipeline's mask route; the FLOP
count against ``torch.utils.flop_counter``; the configuration file's
settings against ``XmemCfg``'s."""
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bundlesdf_tpu_torch import entry
from bundlesdf_tpu_torch.models import xmem
from portbench import xmem_costs
from portbench.reference import xmem as ref

torch.set_num_threads(2)
H, W = 64, 96
SMALL = dict(mem_every=1, min_mid_term_frames=2, max_mid_term_frames=3,
             max_long_term_elements=48, num_prototypes=8, size=64)
# float32 against float32 in another summing order: the session's readings
# are ~1e-6 and below (the TF32 control reads 1e-3 to 2e-2)
TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gap(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.fixture(scope="module")
def sd():
    return ref.make_weights(11)


@pytest.fixture(scope="module")
def net(sd):
    return xmem.load_weights(xmem.XmemNet(), sd).eval()


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    colors = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(14)]
    mask = np.zeros((H, W), np.uint8)
    mask[16:48, 20:70] = 255
    return colors, mask


def ops(sd):
    return ref._Ops(sd, "ref")


@torch.no_grad()
def test_key_encoder_and_projection(net, sd, frames):
    x = ref.prepare(frames[0][0], 64)[0]
    got = net.key_encoder(x)
    want = ref.key_encoder(ops(sd), x)
    for g, w in zip(got, want):
        assert g.shape == w.shape and gap(g, w) < TOL
    assert [t.shape[1] for t in got] == [1024, 512, 256]
    for g, w in zip(net.key_proj(got[0], True), ref.key_projection(ops(sd), want[0], True)):
        assert gap(g, w) < TOL
    assert net.key_proj(got[0], False)[1] is None


@torch.no_grad()
def test_value_encoder_and_deep_update(net, sd, frames):
    x = ref.prepare(frames[0][0], 64)[0]
    f16 = net.key_encoder(x)[0]
    h = torch.randn(1, 64, H // 16, W // 16, generator=torch.Generator().manual_seed(1))
    m = torch.rand(1, 1, H, W, generator=torch.Generator().manual_seed(2))
    value, hidden = net.value_encoder(x, f16, h, m, torch.zeros_like(m))
    rv, rh = ref.value_encoder(ops(sd), x, f16, h, m, 64)
    assert value.shape == (1, 512, H // 16, W // 16)
    assert gap(value, rv) < TOL and gap(hidden, rh) < TOL


@pytest.mark.parametrize("h_out", [True, False])
@torch.no_grad()
def test_decoder_and_sensory_update(net, sd, frames, h_out):
    x = ref.prepare(frames[0][1], 64)[0]
    f16, f8, f4 = net.key_encoder(x)
    gen = torch.Generator().manual_seed(4)
    h = torch.randn(1, 64, H // 16, W // 16, generator=gen)
    readout = torch.randn(1, 512, H // 16, W // 16, generator=gen)
    got = net.decoder(f16, f8, f4, h, readout, h_out)
    want = ref.decoder(ops(sd), f16, f8, f4, h, readout, h_out, 64)
    assert (got[0] is None) == (not h_out) and (want[0] is None) == (not h_out)
    assert got[1].shape == (1, 1, H // 4, W // 4) and got[2].shape == (1, 1, H, W)
    for g, w in zip(got, want):
        if w is not None:
            assert gap(g, w) < TOL


def test_top_k_and_prototypes_ties_go_to_the_lower_index():
    """Exactly tied similarities and usages: the read keeps the lower
    rows, as the reference's stable sort does; the choice of prototypes
    and of evicted elements takes the lower index first."""
    sim = torch.tensor([[1.0, -3.0], [2.0, 5.0], [2.0, 5.0], [2.0, 4.0], [0.5, 5.0]])
    aff = xmem.top_k_softmax(sim, 2)
    want = ref.top_k_affinity(sim, 2)
    assert (aff > 0).nonzero().tolist() == [[1, 0], [1, 1], [2, 0], [2, 1]]
    assert torch.equal(aff > 0, want > 0) and torch.allclose(aff, want)
    assert torch.allclose(aff.sum(0), torch.ones(2))
    usage = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0, 0.0])
    assert xmem.stable_top(usage, 2, largest=True).tolist() == [1, 2]
    assert xmem.stable_top(usage, 2, largest=False).tolist() == [3, 5]


def test_memory_read_against_the_reference():
    """``Memory.read`` over a long-term and a working memory (one
    consolidation) against the reference's ``MemoryManager.match`` from the
    same stores: the readout, and the use and life counts of both."""
    cfg = xmem.XmemCfg(**dict(SMALL, top_k=5))
    gen = torch.Generator().manual_seed(5)
    q = 8
    mem = xmem.Memory(cfg, q, "cpu")
    for _ in range(3):
        mem.add(torch.randn(64, q, generator=gen), torch.rand(1, q, generator=gen) + 1,
                torch.randn(512, q, generator=gen), torch.rand(64, q, generator=gen))
    assert (mem.n_lt, mem.n_wm) == (8, 16)
    mgr = ref.MemoryManager(dict(ref.XMEM, **SMALL, top_k=5), q, mem.state())
    qk, qe = torch.randn(64, q, generator=gen), torch.rand(64, q, generator=gen)
    out = mem.read(qk, qe)
    assert gap(out, mgr.match(ops({}), qk, qe)) < TOL
    st = mem.state()
    for store in ("lt", "wm"):
        want = mgr.state()[store]
        for name in ("use", "life"):
            assert torch.allclose(st[store][name], want[name], atol=1e-6), (store, name)


def test_session_teacher_forced(sd):
    """A session under the shrunk schedule: consolidation from frame 2,
    eviction once the long-term memory holds LT_max - P; each step against
    the reference from the program's own state."""
    cfg = xmem.XmemCfg(**SMALL)
    w = dict(ref.XMEM, **SMALL)
    seg = entry.build_segmenter(cfg, device="cpu", state_dict=sd)
    rng = np.random.default_rng(7)
    mask0 = np.zeros((H, W), np.uint8)
    mask0[10:50, 30:80] = 255
    evictions = consolidations = 0
    for k in range(12):
        color = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        mask = mask0 if k == 0 else None
        state = seg.core.state()
        x, m, pad = ref.prepare(color, 64, mask)
        want = ref.step(sd, state, x, m, w)
        out = seg.step(color, mask)
        got, mem = seg.core.last, seg.core.memory
        names = ["hidden", "value"] + (["readout", "logits4", "logits"] if k else [])
        for name in names:
            assert gap(got[name], want[name]) < TOL, (k, name)
        assert (mem.n_lt, mem.n_wm) == (want["n_lt"], want["n_wm"])
        if want["prototypes"] is not None:
            consolidations += 1
            assert got["prototypes"].tolist() == want["prototypes"].tolist()
        if want["evicted"] is not None:
            evictions += 1
            assert sorted(got["evicted"].tolist()) == sorted(want["evicted"].tolist())
        st = seg.core.state()
        for store in ("lt", "wm"):
            for name, t in want["state"][store].items():
                if t is not None:
                    assert gap(st[store][name], t) < TOL, (k, store, name)
        mask_ref = ref.finish(want["prob"], pad, (H, W)).numpy()
        assert out.dtype == np.uint8 and set(np.unique(out)) <= {0, 255}
        if k == 0:
            np.testing.assert_array_equal(out, mask0)
        else:
            near = (want["prob"][1] - 0.5).abs().numpy() < 1e-5
            assert np.array_equal((out > 0)[~near], mask_ref[~near])
    assert consolidations == 10 and evictions == 5
    assert (seg.core.memory.n_lt, seg.core.memory.n_wm) == (48, 48)


def test_frames_resized_and_padded(sd):
    """A 50 x 70 frame at size 40: resized to 40 x 56 (bilinear), padded
    to 48 x 64, the mask read back at 50 x 70 after the bilinear resize of
    the probabilities; against the reference's ``prepare`` and
    ``finish``."""
    cfg = xmem.XmemCfg(**dict(SMALL, size=40))
    w = dict(ref.XMEM, **dict(SMALL, size=40))
    rng = np.random.default_rng(9)
    colors = [rng.integers(0, 256, (50, 70, 3), dtype=np.uint8) for _ in range(3)]
    mask0 = np.zeros((50, 70), np.uint8)
    mask0[5:40, 10:60] = 255
    x, pad = xmem.prepare_frame(torch.from_numpy(colors[0]), 40)
    rx, rm, rpad = ref.prepare(colors[0], 40, mask0)
    assert x.shape == (1, 3, 48, 64) and pad == rpad == (4, 4, 4, 4)
    assert torch.equal(x, rx)
    assert torch.equal(xmem.prepare_mask(torch.from_numpy(mask0), 40)[0], rm)
    seg = entry.build_segmenter(cfg, device="cpu", state_dict=sd)
    state = ref.empty_state()
    for k, color in enumerate(colors):
        mask = mask0 if k == 0 else None
        xk, mk, _ = ref.prepare(color, 40, mask)
        want = ref.step(sd, state, xk, mk, w)
        state = want["state"]
        out = seg.step(color, mask)
        assert out.shape == (50, 70)
        expect = ref.finish(want["prob"], rpad, (50, 70)).numpy()
        d = torch.tensor([1e-5, -1e-5])[:, None, None]
        sure = (ref.finish(want["prob"] + d, rpad, (50, 70))
                == ref.finish(want["prob"] - d, rpad, (50, 70))).numpy()
        assert sure.mean() > 0.9
        np.testing.assert_array_equal((out > 0)[sure], expect[sure])


def test_first_frame_needs_a_mask(sd):
    seg = entry.build_segmenter(xmem.XmemCfg(**SMALL), device="cpu", state_dict=sd)
    with pytest.raises(ValueError, match="first frame"):
        seg.step(np.zeros((H, W, 3), np.uint8))


def test_weights_load_strictly(sd):
    net = xmem.XmemNet()
    bad = dict(sd)
    bad.pop("decoder.pred.bias")
    with pytest.raises(KeyError, match="decoder.pred.bias"):
        xmem.load_weights(net, bad)
    with pytest.raises(KeyError, match="extra"):
        xmem.load_weights(net, dict(sd, extra=torch.zeros(1)))
    assert set(ref.make_weights(0)) == {k for k in net.state_dict()
                                        if not k.endswith("num_batches_tracked")}
    assert sum(t.numel() for t in sd.values() if t.ndim > 1) > 60_000_000


def test_pipeline_takes_the_segmenters_mask(sd):
    """``BundleSdf.run(..., mask=None)`` with a segmenter: each Frame's
    mask is what the segmenter returned for it; the first frame's is the
    given mask."""
    from synthetic_cube import make_cube_sequence

    data = make_cube_sequence(n_frames=3, H=96, W=96)
    seg = entry.build_segmenter(xmem.XmemCfg(**dict(SMALL, size=96)), device="cpu",
                                state_dict=sd)
    returned = []
    step = seg.step

    def spy(color, mask=None):
        returned.append(step(color, mask))
        return returned[-1]

    seg.step = spy
    tracker = entry.build_tracker(device="cpu", segmenter=seg)
    for k in range(3):
        color = np.asarray(data["colors"][k], np.uint8)
        frame = tracker.run(color, data["depths"][k], data["K"], f"{k:04d}",
                            mask=data["masks"][k] if k == 0 else None)
        np.testing.assert_array_equal(frame.fg_mask, returned[k] > 0)
    np.testing.assert_array_equal(returned[0] > 0, data["masks"][0] > 0)
    assert seg.core.ti == 2


@pytest.mark.parametrize("part", ["key", "decode", "value", "read"])
@torch.no_grad()
def test_flops_match_the_flop_counter(net, part):
    x = torch.randn(1, 3, H, W)
    f16, f8, f4 = net.key_encoder(x)
    h = torch.zeros(1, 64, H // 16, W // 16)
    with FlopCounterMode(display=False) as fc:
        if part == "key":
            f16, f8, f4 = net.key_encoder(x)
            net.key_proj(f16, False)
            want = xmem_costs.key_flops(ref.XMEM, H, W)
        elif part == "decode":
            net.decoder(f16, f8, f4, h, torch.randn(1, 512, H // 16, W // 16), True)
            want = xmem_costs.decode_flops(ref.XMEM, H, W, True)
        elif part == "value":
            net.key_proj.d_proj(f16)
            m = torch.rand(1, 1, H, W)
            net.value_encoder(x, f16, h, m, torch.zeros_like(m))
            want = xmem_costs.value_flops(ref.XMEM, H, W)
        else:
            mem = xmem.Memory(xmem.XmemCfg(), 24, "cpu")
            for _ in range(3):
                mem.add(torch.randn(64, 24), torch.rand(1, 24) + 1, torch.randn(512, 24),
                        torch.rand(64, 24))
            mem.read(torch.randn(64, 24), torch.rand(64, 24))
            want = xmem_costs.read_flops(ref.XMEM, 72, H, W)
    assert fc.get_total_flops() == want
    assert xmem_costs.frame_shape(480, 640, 480) == (480, 640)
    assert xmem_costs.frame_shape(50, 70, 40) == (48, 64)


def test_configuration_is_the_published_settings():
    cfg = json.load(open(os.path.join(REPO, "portbench", "configs", "online_xmem.json")))
    assert cfg["xmem"] == ref.XMEM
    assert {k: v for k, v in ref.XMEM.items() if k != "deep_update_every"} == \
        xmem.XmemCfg()._asdict()
    assert cfg["reduced"] == [] and ref.XMEM["deep_update_every"] == -1


def test_cli_reads_the_first_mask_only(sd, tmp_path, monkeypatch):
    """``run_custom --first_mask_only --xmem_weights FILE``: a video folder
    with frame 0's mask alone tracks every frame, each later mask from XMem
    with the file's weights (here at size 96, the frames' own, on the
    CPU)."""
    import cv2
    from synthetic_cube import make_cube_sequence

    from bundlesdf_tpu_torch.scripts import run_custom

    data = make_cube_sequence(n_frames=3, H=96, W=96)
    vdir = tmp_path / "video"
    for sub in ("rgb", "depth", "masks"):
        (vdir / sub).mkdir(parents=True)
    for k in range(3):
        name = f"{k:05d}.png"
        cv2.imwrite(str(vdir / "rgb" / name), data["colors"][k].astype(np.uint8)[..., ::-1])
        cv2.imwrite(str(vdir / "depth" / name),
                    np.round(data["depths"][k] * 1000).astype(np.uint16))
    cv2.imwrite(str(vdir / "masks" / "00000.png"), (data["masks"][0] > 0).astype(np.uint8) * 255)
    np.savetxt(vdir / "cam_K.txt", data["K"])
    torch.save(sd, tmp_path / "xmem.pth")
    given = []

    def build(device, state_dict):
        assert state_dict.keys() == sd.keys()
        assert all(torch.equal(state_dict[k], sd[k]) for k in sd)
        seg = entry.build_segmenter(xmem.XmemCfg(size=96), device=device, state_dict=state_dict)
        step = seg.step

        def spy(color, mask=None):
            given.append(mask)
            return step(color, mask)

        seg.step = spy
        return seg

    monkeypatch.setattr(run_custom, "build_segmenter", build)
    pipe = run_custom.main(["--mode", "run_video", "--video_dir", str(vdir), "--out_folder",
                            str(vdir / "out"), "--no_nerf", "--first_mask_only",
                            "--xmem_weights", str(tmp_path / "xmem.pth"),
                            "--shorter_side", "96", "--device", "cpu"])
    assert pipe.segmenter.core.ti == 2
    assert given[0] is not None and given[1] is None and given[2] is None
    assert np.array_equal(given[0] > 0, cv2.erode((data["masks"][0] > 0).astype(np.uint8),
                                                  np.ones((5, 5), np.uint8)) > 0)
    assert sorted(os.listdir(vdir / "out" / "ob_in_cam")) == [f"{k:05d}.txt" for k in range(3)]
    assert run_custom.parse_args(["--out_folder", "x"]).first_mask_only is False


def test_first_mask_only_needs_weights(tmp_path, capsys):
    """Without XMem weights the first-mask route is refused, by the parser
    and by ``run_one_video``, before anything runs: seeded weights would
    hand the tracker masks that segment nothing."""
    from bundlesdf_tpu_torch.scripts import run_custom

    with pytest.raises(SystemExit):
        run_custom.parse_args(["--out_folder", "x", "--first_mask_only"])
    assert "--xmem_weights" in capsys.readouterr().err
    with pytest.raises(ValueError, match="xmem_weights"):
        run_custom.run_one_video(str(tmp_path), str(tmp_path / "out"), first_mask_only=True,
                                 device="cpu")
    assert not (tmp_path / "out").exists()
