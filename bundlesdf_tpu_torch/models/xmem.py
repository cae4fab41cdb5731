"""XMem video object segmentation (Cheng & Schwing, "XMem: Long-Term Video
Object Segmentation with an Atkinson-Shiffrin Memory Model", ECCV 2022,
arXiv:2207.07115; github.com/hkchengrex/XMem), the segmenter that BundleSDF
names for the masks of every frame after the first.  One object.

The network (``model/network.py``, ``model/modules.py``):

- the key encoder, ResNet-50 conv1 to layer3: f4 (256 ch, 1/4), f8 (512,
  1/8), f16 (1024, 1/16); the key projection, three 3 x 3 convolutions of
  f16: the key (64), the shrinkage ``d^2 + 1`` and the selection
  ``sigmoid(e)`` (64);
- the value encoder, ResNet-18 conv1 to layer3 over RGB, the mask and the
  other objects' mask (zeros: one object), fused with f16
  (FeatureFusionBlock 1024 + 256 -> 512), and the deep update of the
  sensory memory (a GRU-like 3 x 3 convolution, 512 + 64 -> 3 x 64);
- the decoder: FeatureFusionBlock(1024, 512 + 64 -> 512) over f16, the
  readout and the sensory memory, two UpsampleBlocks (skips f8, f4), the
  3 x 3 prediction at 1/4, upsampled x4 bilinearly; on a frame that adds no
  memory, the sensory update from g16, g8, g4 and the logit.

The memory (``inference/memory_manager.py``): a query pixel reads every
element of the long-term and the working memory by the anisotropic L2
similarity ``-s_i sum_c e_cj (k_ci - q_cj)^2 / sqrt(C_k)`` (expanded as the
upstream computes it), keeps its ``top_k`` elements, softmaxes over them
and reads the values densely.  Each read adds its affinity summed over the
query pixels to the elements' use count and one to their life, in both
memories (eval.py counts the long-term memory's usage when the video could
fill it, length / (T_max - T_min) x P >= LT_max: from 391 frames at these
settings; shorter videos never evict, so the counts go unread).  A memory
frame (every ``mem_every``-th frame, and a frame given a mask) appends its
H/16 x W/16 elements to the working memory; when that holds
``max_mid_term_frames`` frames, the frames between the first and the newest
``min_mid_term_frames - 1`` are consolidated into ``num_prototypes``
prototypes (the candidates of highest use over life; their values and
shrinkage read out from the candidates with a full softmax) appended to the
long-term memory, which first evicts its least-used elements down to
``max_long_term_elements - num_prototypes``.

The memory lives in device buffers sized once from ``max_mid_term_frames``
and ``max_long_term_elements`` (``Memory``): rows [0, n_lt) long-term, then
the working memory.  Every size is known on the host, so no bookkeeping
waits for the device.  Ties go to the lower index first: in the read's
top-k, in the choice of prototypes, and in eviction (the older element
goes).  Departures from the upstream, each equal to it where it is
finite and untied: the top-k softmax subtracts each query's maximum (the
upstream exponentiates the raw similarities, which underflow to 0 / 0 far
from the memory); eviction removes exactly the elements over the limit (the
upstream removes every element tied with the cut-off); the deep update runs
with the memory frames (``deep_update_every`` -1, eval.py's default, the
only mode here).

Convolutions run in float32 through PyTorch's own im2col path
(``conv_blocks.without_cudnn``), with TF32 off, as LoFTR's do.

Spans (``utils/profiler.py``) under ``xmem/step`` (``io/segmentation.py``):
``xmem/encode_key``, ``xmem/read_memory``, ``xmem/decode``,
``xmem/encode_value``, ``xmem/consolidate``.  Counters: ``xmem/frames``,
``xmem/mem_frames``, ``xmem/memory_elements`` (elements each read covered,
summed), ``xmem/long_term_elements`` (the long-term share of those),
``xmem/consolidations``, ``xmem/evicted``, and, on the card while the
profiler records, ``xmem/read_memory_device_us``: the read's device time
between two CUDA events, added once the frame's readback has waited for
them (``account_read_time``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import profiler
from ..utils.profiler import span
from .conv_blocks import BasicBlock, Bottleneck, FrozenBatchNorm2d, res_layer, without_cudnn

IM_MEAN = (0.485, 0.456, 0.406)
IM_STD = (0.229, 0.224, 0.225)
# a new element's life count (memory_manager.py: 1e-7, so that use / life
# is 0 before its first read)
NEW_LIFE = 1e-7
PROB_CLAMP = 1e-7


class XmemCfg(NamedTuple):
    """The published widths (``model/network.py``) and the inference
    settings of ``eval.py``'s defaults."""
    key_dim: int = 64
    value_dim: int = 512
    hidden_dim: int = 64
    top_k: int = 30
    mem_every: int = 5
    min_mid_term_frames: int = 5        # T_min
    max_mid_term_frames: int = 10       # T_max
    max_long_term_elements: int = 10000  # LT_max
    num_prototypes: int = 128           # P
    size: int = 480                     # the shorter side frames are resized to


# ------------------------------------------------------------- network ---
def _conv_b(cin: int, cout: int, k: int) -> nn.Conv2d:
    """A convolution with bias, padded to keep the size (GConv2D)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2)


def _gru(values: torch.Tensor, h: torch.Tensor, hd: int) -> torch.Tensor:
    """The upstream's GRU-like update (the new value made before the
    forget gate, modules.py HiddenUpdater)."""
    forget = torch.sigmoid(values[:, :hd])
    update = torch.sigmoid(values[:, hd:2 * hd])
    new = torch.tanh(values[:, 2 * hd:])
    return forget * h * (1 - update) + update * new


def area_down(x: torch.Tensor, ratio: float) -> torch.Tensor:
    return F.interpolate(x, scale_factor=ratio, mode="area")


def up_bilinear(x: torch.Tensor, ratio: float) -> torch.Tensor:
    return F.interpolate(x, scale_factor=ratio, mode="bilinear", align_corners=False)


class GroupResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.downsample = None if cin == cout else _conv_b(cin, cout, 3)
        self.conv1 = _conv_b(cin, cout, 3)
        self.conv2 = _conv_b(cout, cout, 3)

    def forward(self, g):
        out = self.conv2(F.relu(self.conv1(F.relu(g))))
        if self.downsample is not None:
            g = self.downsample(g)
        return out + g


class _BasicConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = _conv_b(cin, cout, k)

    def forward(self, x):
        return self.conv(x)


class ChannelGate(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(nn.Flatten(), nn.Linear(c, c // reduction), nn.ReLU(),
                                 nn.Linear(c // reduction, c))

    def forward(self, x):
        att = self.mlp(x.mean((2, 3), keepdim=True)) + self.mlp(x.amax((2, 3), keepdim=True))
        return x * torch.sigmoid(att)[:, :, None, None]


class SpatialGate(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial = _BasicConv(2, 1, 7)

    def forward(self, x):
        pooled = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.spatial(pooled))


class CBAM(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ChannelGate = ChannelGate(c)
        self.SpatialGate = SpatialGate()

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


class FeatureFusionBlock(nn.Module):
    def __init__(self, x_in: int, g_in: int, g_mid: int, g_out: int):
        super().__init__()
        self.block1 = GroupResBlock(x_in + g_in, g_mid)
        self.attention = CBAM(g_mid)
        self.block2 = GroupResBlock(g_mid, g_out)

    def forward(self, x, g):
        g = self.block1(torch.cat([x, g], 1))
        return self.block2(g + self.attention(g))


class HiddenUpdater(nn.Module):
    def __init__(self, g_dims, mid: int, hidden: int):
        super().__init__()
        self.hidden_dim = hidden
        self.g16_conv = _conv_b(g_dims[0], mid, 1)
        self.g8_conv = _conv_b(g_dims[1], mid, 1)
        self.g4_conv = _conv_b(g_dims[2], mid, 1)
        self.transform = _conv_b(mid + hidden, hidden * 3, 3)

    def forward(self, g16, g8, g4, h):
        g = (self.g16_conv(g16) + self.g8_conv(area_down(g8, 1 / 2))
             + self.g4_conv(area_down(g4, 1 / 4)))
        return _gru(self.transform(torch.cat([g, h], 1)), h, self.hidden_dim)


class HiddenReinforcer(nn.Module):
    def __init__(self, g_dim: int, hidden: int):
        super().__init__()
        self.hidden_dim = hidden
        self.transform = _conv_b(g_dim + hidden, hidden * 3, 3)

    def forward(self, g, h):
        return _gru(self.transform(torch.cat([g, h], 1)), h, self.hidden_dim)


class UpsampleBlock(nn.Module):
    def __init__(self, skip_dim: int, g_up: int, g_out: int):
        super().__init__()
        self.skip_conv = _conv_b(skip_dim, g_up, 3)
        self.out_conv = GroupResBlock(g_up, g_out)

    def forward(self, skip_f, up_g):
        return self.out_conv(self.skip_conv(skip_f) + up_bilinear(up_g, 2))


class KeyEncoder(nn.Module):
    """ResNet-50 conv1 .. layer3 (torchvision's names; layer1 is ``res2``)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.res2 = res_layer(Bottleneck, 64, 64, 3, 1)
        self.layer2 = res_layer(Bottleneck, 256, 128, 4, 2)
        self.layer3 = res_layer(Bottleneck, 512, 256, 6, 2)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        f4 = self.res2(x)
        f8 = self.layer2(f4)
        return self.layer3(f8), f8, f4


class KeyProjection(nn.Module):
    def __init__(self, cin: int, key_dim: int):
        super().__init__()
        self.key_proj = _conv_b(cin, key_dim, 3)
        self.d_proj = _conv_b(cin, 1, 3)
        self.e_proj = _conv_b(cin, key_dim, 3)

    def forward(self, x, need_s: bool):
        s = self.d_proj(x) ** 2 + 1 if need_s else None
        return self.key_proj(x), s, torch.sigmoid(self.e_proj(x))


class ValueEncoder(nn.Module):
    """ResNet-18 conv1 .. layer3 over (RGB, mask, others), fused with f16;
    the deep update of the sensory memory."""

    def __init__(self, value_dim: int, hidden_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(5, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.layer1 = res_layer(BasicBlock, 64, 64, 2, 1)
        self.layer2 = res_layer(BasicBlock, 64, 128, 2, 2)
        self.layer3 = res_layer(BasicBlock, 128, 256, 2, 2)
        self.fuser = FeatureFusionBlock(1024, 256, value_dim, value_dim)
        self.hidden_reinforce = HiddenReinforcer(value_dim, hidden_dim)

    def forward(self, image, f16, h, mask, others):
        g = torch.cat([image, mask, others], 1)
        g = F.relu(F.max_pool2d(self.bn1(self.conv1(g)), 3, 2, 1))
        g = self.layer3(self.layer2(self.layer1(g)))
        g = self.fuser(f16, g)
        return g, self.hidden_reinforce(g, h)


class Decoder(nn.Module):
    def __init__(self, value_dim: int, hidden_dim: int):
        super().__init__()
        self.fuser = FeatureFusionBlock(1024, value_dim + hidden_dim, 512, 512)
        self.hidden_update = HiddenUpdater([512, 256, 256 + 1], 256, hidden_dim)
        self.up_16_8 = UpsampleBlock(512, 512, 256)
        self.up_8_4 = UpsampleBlock(256, 256, 256)
        self.pred = _conv_b(256, 1, 3)

    def forward(self, f16, f8, f4, hidden, readout, h_out: bool):
        """-> (the new sensory memory or None, logits at 1/4, logits x4)."""
        g16 = self.fuser(f16, torch.cat([readout, hidden], 1))
        g8 = self.up_16_8(f8, g16)
        g4 = self.up_8_4(f4, g8)
        logits4 = self.pred(F.relu(g4))
        new_h = (self.hidden_update(g16, g8, torch.cat([g4, logits4], 1), hidden)
                 if h_out else None)
        return new_h, logits4, up_bilinear(logits4, 4)


class XmemNet(nn.Module):
    def __init__(self, cfg: XmemCfg = XmemCfg()):
        super().__init__()
        self.cfg = cfg
        self.key_encoder = KeyEncoder()
        self.key_proj = KeyProjection(1024, cfg.key_dim)
        self.value_encoder = ValueEncoder(cfg.value_dim, cfg.hidden_dim)
        self.decoder = Decoder(cfg.value_dim, cfg.hidden_dim)


def init_weights(net: XmemNet, seed: int = 0) -> XmemNet:
    """Seeded random weights from one ``torch.Generator``, by the
    upstream's schemes: the ResNets' convolutions kaiming-normal fan-out
    (torchvision), BatchNorm at identity, the key projection orthogonal with
    a zero bias, the GRU transforms xavier-normal, every other layer
    PyTorch's default (uniform within 1 / sqrt(fan_in))."""
    gen = torch.Generator().manual_seed(int(seed))
    resnets = (net.key_encoder, net.value_encoder)
    backbone = {id(m) for r in resnets
                for n, m in r.named_modules() if not n.startswith("fuser")
                and not n.startswith("hidden_reinforce")}
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                if id(m) in backbone:
                    nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                            generator=gen)
                elif name == "key_proj.key_proj":
                    nn.init.orthogonal_(m.weight, generator=gen)
                elif name.endswith("transform"):
                    nn.init.xavier_normal_(m.weight, generator=gen)
                else:
                    nn.init.uniform_(m.weight, -bound, bound, generator=gen)
                if m.bias is not None:
                    if name == "key_proj.key_proj":
                        m.bias.zero_()
                    else:
                        nn.init.uniform_(m.bias, -bound, bound, generator=gen)
    return net


def load_weights(net: XmemNet, state_dict: dict) -> XmemNet:
    """Load a state dict of the port's names (the module tree above; arrays
    or tensors).  Every weight must be present and no other key given, but
    BatchNorm's ``num_batches_tracked`` may be absent."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    res = net.load_state_dict(sd, strict=False)
    missing = [k for k in res.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or res.unexpected_keys:
        raise KeyError(f"XMem weights: missing {missing}, unexpected {res.unexpected_keys}")
    return net


# -------------------------------------------------------------- frames ---
def prepare_frame(image: torch.Tensor, size: int):
    """An (H, W, 3) uint8 RGB frame as the network takes it: [0, 1],
    normalised by ImageNet's mean and std, its shorter side resized to
    ``size`` (bilinear) unless it is that already, zero-padded on both
    sides to multiples of 16 (the upstream's ``pad_divide_by``).  Returns
    (1, 3, H', W') and the padding (left, right, top, bottom)."""
    x = image.permute(2, 0, 1).to(torch.float32) / 255.0
    mean = torch.tensor(IM_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IM_STD, device=x.device)[:, None, None]
    x = ((x - mean) / std)[None]
    shape = resized_shape(x.shape[-2:], size)
    if shape != tuple(x.shape[-2:]):
        x = F.interpolate(x, size=shape, mode="bilinear", align_corners=False)
    return pad16(x)


def resized_shape(hw, size: int) -> tuple:
    """(H, W) with the shorter side at ``size`` (torchvision's ``Resize(size)``
    rule: the longer side ``int(size * long / short)``)."""
    h, w = int(hw[0]), int(hw[1])
    if min(h, w) == size:
        return h, w
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def prepare_mask(mask: torch.Tensor, size: int):
    """An (H, W) mask (non-zero: the object) as a (1, 1, H', W') float at
    the frame's resize (nearest) and padding."""
    m = (mask > 0).to(torch.float32)[None, None]
    shape = resized_shape(m.shape[-2:], size)
    if shape != tuple(m.shape[-2:]):
        m = F.interpolate(m, size=shape, mode="nearest")
    return pad16(m)


def pad16(x: torch.Tensor):
    h, w = x.shape[-2:]
    ph, pw = (-h) % 16, (-w) % 16
    pad = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    return (F.pad(x, pad) if any(pad) else x), pad


def unpad(x: torch.Tensor, pad) -> torch.Tensor:
    l, r, t, b = pad
    return x[..., t:x.shape[-2] - b, l:x.shape[-1] - r]


def aggregate(prob: torch.Tensor) -> torch.Tensor:
    """(1, H, W) object probability -> (2, H, W) with the background
    (soft aggregation, ``aggregate``): ``[prod(1 - p), p]`` clamped to
    [1e-7, 1 - 1e-7], through logits ``log(p / (1 - p))`` and a softmax."""
    new = torch.cat([torch.prod(1 - prob, 0, keepdim=True), prob], 0).clamp(
        PROB_CLAMP, 1 - PROB_CLAMP)
    return torch.softmax(torch.log(new / (1 - new)), 0)


# --------------------------------------------------------------- memory ---
def similarity(mk: torch.Tensor, ms: torch.Tensor, qk: torch.Tensor,
               qe: torch.Tensor) -> torch.Tensor:
    """(N, Q): memory keys ``mk`` (N, C) and shrinkage ``ms`` (N,) against
    query keys ``qk`` and selection ``qe`` (C, Q), in the upstream's
    expanded form (``get_similarity``)."""
    a_sq = mk.pow(2) @ qe
    two_ab = 2 * (mk @ (qk * qe))
    b_sq = (qe * qk.pow(2)).sum(0, keepdim=True)
    return (-a_sq + two_ab - b_sq) * ms[:, None] / math.sqrt(mk.shape[1])


def top_k_softmax(sim: torch.Tensor, k: int) -> torch.Tensor:
    """Each column's ``k`` largest entries (the lower row first among equal
    values) softmaxed, zero elsewhere: the dense affinity, (N, Q)."""
    k = min(k, sim.shape[0])
    vals = torch.topk(sim, k, dim=0).values
    thr = vals[-1:]
    above = sim > thr
    tied = sim == thr
    need = k - above.sum(0, keepdim=True, dtype=torch.int32)
    keep = above | (tied & (torch.cumsum(tied, 0, dtype=torch.int32) <= need))
    aff = torch.where(keep, torch.exp(sim - vals[:1]), torch.zeros((), device=sim.device))
    return aff / aff.sum(0, keepdim=True)


def stable_top(x: torch.Tensor, n: int, largest: bool) -> torch.Tensor:
    """The indices of ``x``'s ``n`` largest (or smallest) entries, in that
    order, the lower index first among equal values."""
    return torch.sort(x, descending=largest, stable=True)[1][:n]


class Memory:
    """The long-term and the working memory in device buffers sized once
    (module docstring).  Keys, selection: (rows, C_k); shrinkage, use and
    life counts: (rows,); values: (C_v, rows)."""

    def __init__(self, cfg: XmemCfg, hw: int, device):
        self.cfg, self.hw = cfg, hw
        self.work_cap = cfg.max_mid_term_frames * hw
        cap = cfg.max_long_term_elements + self.work_cap
        ck = cfg.key_dim
        z = dict(device=device, dtype=torch.float32)
        self.key = torch.zeros(cap, ck, **z)
        self.sel = torch.zeros(cap, ck, **z)
        self.shrink = torch.zeros(cap, **z)
        self.value = torch.zeros(cfg.value_dim, cap, **z)
        self.use = torch.zeros(cap, **z)
        self.life = torch.zeros(cap, **z)
        self.n_lt = 0
        self.n_wm = 0

    @property
    def size(self) -> int:
        return self.n_lt + self.n_wm

    def read(self, qk: torch.Tensor, qe: torch.Tensor) -> torch.Tensor:
        """The readout (C_v, Q) of query keys and selection (C_k, Q); the
        use and life counts updated."""
        n = self.size
        sim = similarity(self.key[:n], self.shrink[:n], qk, qe)
        aff = top_k_softmax(sim, self.cfg.top_k)
        self.use[:n] += aff.sum(1)
        self.life[:n] += 1
        profiler.count("xmem/memory_elements", n)
        profiler.count("xmem/long_term_elements", self.n_lt)
        return self.value[:, :n] @ aff

    def add(self, key, shrink, value, sel):
        """Append a memory frame: key, selection (C_k, Q), shrinkage (1, Q),
        value (C_v, Q); consolidate when the working memory is full, and
        return ``consolidate``'s indices then (None otherwise)."""
        q = key.shape[1]
        a = self.size
        self.key[a:a + q] = key.T
        self.sel[a:a + q] = sel.T
        self.shrink[a:a + q] = shrink[0]
        self.value[:, a:a + q] = value
        self.use[a:a + q] = 0
        self.life[a:a + q] = NEW_LIFE
        self.n_wm += q
        if self.n_wm < self.work_cap:
            return None
        with span("xmem/consolidate"):
            return self.consolidate()

    def consolidate(self) -> tuple:
        """-> the prototypes (indices into the candidates, by use over life)
        and the evicted long-term elements (indices into the long-term
        memory; None below its limit)."""
        cfg, hw = self.cfg, self.hw
        P = cfg.num_prototypes
        lt_keep = torch.arange(self.n_lt, device=self.key.device)
        evicted = None
        limit = cfg.max_long_term_elements - P
        if self.n_lt >= limit:
            usage = self.use[:self.n_lt] / self.life[:self.n_lt]
            order = stable_top(usage, self.n_lt, largest=False)
            n_out = self.n_lt - limit
            evicted = order[:n_out]
            lt_keep = torch.sort(order[n_out:])[0]
            profiler.count("xmem/evicted", n_out)
        c0 = self.n_lt + hw
        c1 = self.size - cfg.min_mid_term_frames * hw + hw
        usage = self.use[c0:c1] / self.life[c0:c1]
        idx = stable_top(usage, P, largest=True)
        ck, cs = self.key[c0:c1], self.shrink[c0:c1]
        pk, pe = ck[idx], self.sel[c0:c1][idx]
        aff = torch.softmax(similarity(ck, cs, pk.T, pe.T), 0)
        pv = self.value[:, c0:c1] @ aff
        ps = cs[None] @ aff
        wm_keep = torch.cat([torch.arange(self.n_lt, c0, device=self.key.device),
                             torch.arange(c1, self.size, device=self.key.device)])
        rows = torch.cat([lt_keep, wm_keep])
        n_lt = len(lt_keep)
        moved = [t.index_select(0, rows) for t in (self.key, self.sel, self.shrink, self.use,
                                                   self.life)]
        value = self.value.index_select(1, rows)
        n_new = n_lt + P + len(wm_keep)
        for buf, t, proto in zip((self.key, self.sel, self.shrink, self.use, self.life), moved,
                                 (pk, pe, ps[0], 0.0, NEW_LIFE)):
            buf[:n_lt] = t[:n_lt]
            buf[n_lt:n_lt + P] = proto
            buf[n_lt + P:n_new] = t[n_lt:]
        self.value[:, :n_lt] = value[:, :n_lt]
        self.value[:, n_lt:n_lt + P] = pv
        self.value[:, n_lt + P:n_new] = value[:, n_lt:]
        self.n_lt = n_lt + P
        self.n_wm = len(wm_keep)
        profiler.count("xmem/consolidations")
        return idx, evicted

    def state(self) -> dict:
        """Copies of both stores in the upstream's layout (keys, selection
        and values (C, N), shrinkage, use and life (1, N)): long-term
        ``lt`` (no selection) and working ``wm``."""
        def cols(lo, hi, sel):
            out = {"k": self.key[lo:hi].T.clone(), "s": self.shrink[lo:hi][None].clone(),
                   "v": self.value[:, lo:hi].clone(), "use": self.use[lo:hi][None].clone(),
                   "life": self.life[lo:hi][None].clone()}
            if sel:
                out["e"] = self.sel[lo:hi].T.clone()
            return out

        return {"lt": cols(0, self.n_lt, False), "wm": cols(self.n_lt, self.size, True)}


# ------------------------------------------------------------ inference ---
class XmemProcessor:
    """The upstream's ``InferenceCore`` for one object: ``step`` segments a
    prepared frame from the memory, and makes it a memory frame every
    ``mem_every`` frames and whenever it is given a mask (the first frame
    must be).  ``last`` keeps the step's intermediate tensors by reference:
    ``readout``, ``logits4``, ``logits`` (frames after the first), on a
    memory frame ``value``, on a consolidation ``prototypes`` and
    ``evicted`` (``Memory.consolidate``), and ``hidden``, the sensory
    memory the step leaves."""

    def __init__(self, net: XmemNet, cfg: XmemCfg):
        self.net, self.cfg = net, cfg
        self.reset()

    def reset(self) -> None:
        self.ti = -1
        self.last_mem_ti = 0
        self.memory: Memory | None = None
        self.hidden = None
        self.last: dict = {}
        self._read_events = None

    def state(self) -> dict:
        """The state a step starts from, as copies: the frame counters, the
        sensory memory and both stores (``Memory.state``)."""
        out = {"ti": self.ti, "last_mem_ti": self.last_mem_ti,
               "hidden": None if self.hidden is None else self.hidden.clone()}
        if self.memory is not None:
            out.update(self.memory.state())
        return out

    @torch.inference_mode()
    def step(self, image: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """``image`` (1, 3, H, W), ``mask`` (1, 1, H, W) or None, both
        prepared (``prepare_frame``, ``prepare_mask``) -> the (2, H, W)
        background and object probabilities."""
        cfg, net = self.cfg, self.net
        self.ti += 1
        if self.ti == 0 and mask is None:
            raise ValueError("XMem needs the first frame's mask")
        is_mem = self.ti - self.last_mem_ti >= cfg.mem_every or mask is not None
        self.last = {}
        profiler.count("xmem/frames")
        with without_cudnn():
            with span("xmem/encode_key"):
                f16, f8, f4 = net.key_encoder(image)
                key, shrink, sel = net.key_proj(f16, is_mem)
            h, w = key.shape[-2:]
            if self.memory is None:
                self.memory = Memory(cfg, h * w, key.device)
                self.hidden = torch.zeros(1, cfg.hidden_dim, h, w, device=key.device)
            qk, qe = key[0].flatten(1), sel[0].flatten(1)
            prob = None
            if self.ti > 0:
                with span("xmem/read_memory"):
                    readout = self._timed_read(qk, qe).view(1, cfg.value_dim, h, w)
                with span("xmem/decode"):
                    new_h, logits4, logits = net.decoder(f16, f8, f4, self.hidden, readout,
                                                         h_out=not is_mem)
                    if new_h is not None:
                        self.hidden = new_h
                    prob = aggregate(torch.sigmoid(logits[0]))
                self.last.update(readout=readout, logits4=logits4, logits=logits)
            if mask is not None:
                prob = aggregate(mask[0])
            if is_mem:
                profiler.count("xmem/mem_frames")
                with span("xmem/encode_value"):
                    obj = prob[1:][None]
                    value, self.hidden = net.value_encoder(image, f16, self.hidden, obj,
                                                           torch.zeros_like(obj))
                self.last["value"] = value
                merged = self.memory.add(qk, shrink[0].flatten(1), value[0].flatten(1), qe)
                if merged is not None:
                    self.last.update(prototypes=merged[0], evicted=merged[1])
                self.last_mem_ti = self.ti
            self.last["hidden"] = self.hidden
        return prob

    def _timed_read(self, qk, qe):
        if qk.device.type != "cuda" or not profiler.recording():
            return self.memory.read(qk, qe)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.memory.read(qk, qe)
        end.record()
        self._read_events = (start, end)
        return out

    def account_read_time(self) -> None:
        """Add the last read's device time to ``xmem/read_memory_device_us``
        (call after a wait that covers the read)."""
        if self._read_events is not None:
            start, end = self._read_events
            self._read_events = None
            profiler.count("xmem/read_memory_device_us",
                           int(round(start.elapsed_time(end) * 1e3)))
