"""Plain PyTorch reference of XMem (Cheng & Schwing, "XMem: Long-Term Video
Object Segmentation with an Atkinson-Shiffrin Memory Model", ECCV 2022,
arXiv:2207.07115; github.com/hkchengrex/XMem), the video segmenter that
BundleSDF's readme names for the masks of every frame, written in float32
from the paper's §3 and the upstream's ``model/network.py``,
``model/modules.py``, ``model/memory_util.py``,
``inference/memory_manager.py``, ``inference/inference_core.py`` and
``eval.py``, as recalled.  It imports nothing of the program.

The weights are a state dict under the names of the upstream's module tree
(``key_encoder.res2.0.conv1.weight``, ``decoder.fuser.block1.conv1.bias``,
``value_encoder.fuser.attention.ChannelGate.mlp.1.weight``, ...):
``make_weights`` draws one from a seed with the upstream's init schemes,
and the program loads the same dict.

- ``key_encoder``: ResNet-50 conv1 .. layer3 (torchvision's v1.5
  Bottleneck, the stride on the 3 x 3), BatchNorm at its running
  statistics: f16, f8, f4;
- ``key_projection``: the key, the shrinkage ``d^2 + 1``, the selection
  ``sigmoid(e)``, each a 3 x 3 convolution of f16;
- ``value_encoder``: ResNet-18 conv1 .. layer3 over (RGB, mask, others),
  the FeatureFusionBlock with f16 and the deep update of the sensory memory;
- ``decoder``: the FeatureFusionBlock over (f16, readout, sensory memory),
  two UpsampleBlocks, the prediction at 1/4 and its x4 bilinear upsample,
  and the sensory update on frames that add no memory;
- the memory (``Store``, ``MemoryManager``): growing tensors, concatenated
  and sliced exactly as the upstream's ``KeyValueMemoryStore`` is; the read
  (``similarity``, ``top_k_affinity``, the dense readout) and its usage;
  consolidation into prototypes with potentiation (a full softmax over the
  candidates); long-term eviction by use over life;
- ``step``: ``InferenceCore.step`` for one object, from a state (frame
  counters, sensory memory, both stores), on a frame prepared as
  ``eval.py`` prepares it (``prepare``: ImageNet normalisation, shorter
  side resized to ``size``, zero padding to multiples of 16).

Assumed, as recalled and not checked (no network here): the CBAM spatial
gate is one 7 x 7 convolution (2 -> 1, with bias, no BatchNorm) of the
channel max and mean, in that order; the channel gate's MLP is
Linear-ReLU-Linear with biases over the average- and the max-pooled map;
potentiation softmaxes over every candidate (no top-k); the resize is
bilinear without antialiasing; the long-term memory's usage is counted
(eval.py's ``enable_long_term_count_usage``, true from 391 frames at the
published settings, and unread before eviction).

Departures, each equal to the upstream where it is finite and untied:

- the top-k softmax subtracts each query's largest similarity before the
  exponential (the upstream exponentiates the raw values, which underflow
  to 0 / 0 for a query far from every memory element);
- ties go to the lower index first: in the read's top-k (a stable sort),
  in the choice of prototypes and in eviction (the upstream's
  ``torch.topk`` leaves their order open);
- eviction removes exactly the elements over ``LT_max - P`` (the upstream
  removes every element tied with the cut-off too);
- one object: the "others" channel of the value encoder is zeros, and the
  object group dimension is left out;
- the deep update runs with the memory frames (``deep_update_every`` -1,
  eval.py's default);
- ``end`` (the upstream's last-frame flag, which skips the memory write) is
  not taken: a session's last frame is not a memory frame in the cells;
- convolutions run with cuDNN off (PyTorch's own im2col and GEMM), so that
  the reference fits beside the program on the card.

``precision="ref"`` computes in float32 with TF32 off for cuBLAS and cuDNN
(both switches restored afterwards).  ``precision="tf32"`` is the control,
one precision below: both switches on, and every operand of a
convolution, linear layer and product rounded to TF32 (``loftr.tf32_round``),
so that the control is the same on a CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .loftr import _matmul_precision, tf32_round
from .loftr_train import _without_cudnn

# The published widths (model/network.py) and eval.py's defaults.
XMEM = {"key_dim": 64, "value_dim": 512, "hidden_dim": 64, "top_k": 30, "mem_every": 5,
        "deep_update_every": -1, "min_mid_term_frames": 5, "max_mid_term_frames": 10,
        "max_long_term_elements": 10000, "num_prototypes": 128, "size": 480}
IM_MEAN = (0.485, 0.456, 0.406)
IM_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
NEW_LIFE = 1e-7
CLAMP = 1e-7


# ----------------------------------------------------------- the weights ---

def _bottleneck_names(prefix: str, cin: int, planes: int, first: bool) -> dict:
    out = planes * 4
    d = {f"{prefix}.conv1": ((planes, cin, 1, 1), "resnet"), f"{prefix}.bn1": planes,
         f"{prefix}.conv2": ((planes, planes, 3, 3), "resnet"), f"{prefix}.bn2": planes,
         f"{prefix}.conv3": ((out, planes, 1, 1), "resnet"), f"{prefix}.bn3": out}
    if first:
        d[f"{prefix}.downsample.0"] = ((out, cin, 1, 1), "resnet")
        d[f"{prefix}.downsample.1"] = out
    return d


def _basic_names(prefix: str, cin: int, planes: int, stride: int) -> dict:
    d = {f"{prefix}.conv1": ((planes, cin, 3, 3), "resnet"), f"{prefix}.bn1": planes,
         f"{prefix}.conv2": ((planes, planes, 3, 3), "resnet"), f"{prefix}.bn2": planes}
    if stride != 1:
        d[f"{prefix}.downsample.0"] = ((planes, cin, 1, 1), "resnet")
        d[f"{prefix}.downsample.1"] = planes
    return d


def _res_block_names(prefix: str, cin: int, cout: int) -> dict:
    d = {f"{prefix}.conv1": ((cout, cin, 3, 3), "conv"),
         f"{prefix}.conv2": ((cout, cout, 3, 3), "conv")}
    if cin != cout:
        d[f"{prefix}.downsample"] = ((cout, cin, 3, 3), "conv")
    return d


def _fusion_names(prefix: str, x_in: int, g_in: int, g_mid: int, g_out: int) -> dict:
    a = f"{prefix}.attention"
    d = _res_block_names(f"{prefix}.block1", x_in + g_in, g_mid)
    d.update({f"{a}.ChannelGate.mlp.1": ((g_mid // 16, g_mid), "linear"),
              f"{a}.ChannelGate.mlp.3": ((g_mid, g_mid // 16), "linear"),
              f"{a}.SpatialGate.spatial.conv": ((1, 2, 7, 7), "conv")})
    d.update(_res_block_names(f"{prefix}.block2", g_mid, g_out))
    return d


def layers(w: dict = XMEM) -> dict:
    """Every layer, in the order it runs: name -> (weight shape, init
    scheme) for convolutions and linear layers, channels for BatchNorm."""
    ck, cv, hd = w["key_dim"], w["value_dim"], w["hidden_dim"]
    d = {"key_encoder.conv1": ((64, 3, 7, 7), "resnet"), "key_encoder.bn1": 64}
    cin = 64
    for name, planes, n in (("res2", 64, 3), ("layer2", 128, 4), ("layer3", 256, 6)):
        for i in range(n):
            d.update(_bottleneck_names(f"key_encoder.{name}.{i}", cin, planes, i == 0))
            cin = planes * 4
    d.update({"key_proj.key_proj": ((ck, 1024, 3, 3), "orthogonal"),
              "key_proj.d_proj": ((1, 1024, 3, 3), "conv"),
              "key_proj.e_proj": ((ck, 1024, 3, 3), "conv")})
    d.update({"value_encoder.conv1": ((64, 5, 7, 7), "resnet"), "value_encoder.bn1": 64})
    cin = 64
    for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2)), start=1):
        for i in range(2):
            d.update(_basic_names(f"value_encoder.layer{li}.{i}", cin, planes,
                                  stride if i == 0 else 1))
            cin = planes
    d.update(_fusion_names("value_encoder.fuser", 1024, 256, cv, cv))
    d["value_encoder.hidden_reinforce.transform"] = ((3 * hd, cv + hd, 3, 3), "xavier")
    d.update(_fusion_names("decoder.fuser", 1024, cv + hd, 512, 512))
    d.update({"decoder.hidden_update.g16_conv": ((256, 512, 1, 1), "conv"),
              "decoder.hidden_update.g8_conv": ((256, 256, 1, 1), "conv"),
              "decoder.hidden_update.g4_conv": ((256, 257, 1, 1), "conv"),
              "decoder.hidden_update.transform": ((3 * hd, 256 + hd, 3, 3), "xavier"),
              "decoder.up_16_8.skip_conv": ((512, 512, 3, 3), "conv")})
    d.update(_res_block_names("decoder.up_16_8.out_conv", 512, 256))
    d["decoder.up_8_4.skip_conv"] = ((256, 256, 3, 3), "conv")
    d.update(_res_block_names("decoder.up_8_4.out_conv", 256, 256))
    d["decoder.pred"] = ((1, 256, 3, 3), "conv")
    return d


def make_weights(seed: int, w: dict = XMEM) -> dict:
    """A state dict from ``seed`` (on the CPU) with the upstream's init:
    the ResNets' convolutions kaiming-normal fan-out (torchvision), their
    BatchNorm at identity; the key projection orthogonal with a zero bias
    (modules.py KeyProjection); the GRU transforms xavier-normal; every other
    convolution and linear layer PyTorch's default, weight and bias uniform
    within 1 / sqrt(fan_in)."""
    from ..draws import mix

    gen = torch.Generator().manual_seed(mix(seed, 7))
    sd = {}
    for name, spec in layers(w).items():
        if isinstance(spec, int):
            sd[f"{name}.weight"] = torch.ones(spec)
            sd[f"{name}.bias"] = torch.zeros(spec)
            sd[f"{name}.running_mean"] = torch.zeros(spec)
            sd[f"{name}.running_var"] = torch.ones(spec)
            continue
        shape, kind = spec
        t = torch.empty(shape)
        fan_in = math.prod(shape[1:])
        bound = 1.0 / math.sqrt(fan_in)
        if kind == "resnet":
            fan_out = shape[0] * math.prod(shape[2:])
            t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
        elif kind == "orthogonal":
            torch.nn.init.orthogonal_(t, generator=gen)
        elif kind == "xavier":
            fan_out = shape[0] * math.prod(shape[2:])
            t.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=gen)
        else:
            t.uniform_(-bound, bound, generator=gen)
        sd[f"{name}.weight"] = t
        if kind != "resnet":
            b = torch.empty(shape[0])
            if kind == "orthogonal":
                b.zero_()
            else:
                b.uniform_(-bound, bound, generator=gen)
            sd[f"{name}.bias"] = b
    return sd


# -------------------------------------------------------------- the ops ---

class _Ops:
    """The layers of one step, with the operands of every product rounded
    to TF32 in the control."""

    def __init__(self, sd: dict, precision: str):
        if precision not in ("ref", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.sd = sd
        self.r = tf32_round if precision == "tf32" else (lambda t: t)

    def conv(self, x, name, stride=1):
        wt = self.sd[f"{name}.weight"]
        return F.conv2d(self.r(x), self.r(wt), self.sd.get(f"{name}.bias"), stride,
                        wt.shape[-1] // 2)

    def bn(self, x, name):
        s = self.sd
        return F.batch_norm(x, s[f"{name}.running_mean"], s[f"{name}.running_var"],
                            s[f"{name}.weight"], s[f"{name}.bias"], False, 0.0, BN_EPS)

    def linear(self, x, name):
        return F.linear(self.r(x), self.r(self.sd[f"{name}.weight"]), self.sd[f"{name}.bias"])

    def mm(self, a, b):
        return self.r(a) @ self.r(b)


def _bottleneck(o, x, p, stride):
    y = F.relu(o.bn(o.conv(x, f"{p}.conv1"), f"{p}.bn1"))
    y = F.relu(o.bn(o.conv(y, f"{p}.conv2", stride), f"{p}.bn2"))
    y = o.bn(o.conv(y, f"{p}.conv3"), f"{p}.bn3")
    if f"{p}.downsample.0.weight" in o.sd:
        x = o.bn(o.conv(x, f"{p}.downsample.0", stride), f"{p}.downsample.1")
    return F.relu(x + y)


def _basic(o, x, p, stride):
    y = F.relu(o.bn(o.conv(x, f"{p}.conv1", stride), f"{p}.bn1"))
    y = o.bn(o.conv(y, f"{p}.conv2"), f"{p}.bn2")
    if f"{p}.downsample.0.weight" in o.sd:
        x = o.bn(o.conv(x, f"{p}.downsample.0", stride), f"{p}.downsample.1")
    return F.relu(x + y)


def key_encoder(o, x):
    """(1, 3, H, W) -> f16, f8, f4."""
    p = "key_encoder"
    x = F.max_pool2d(F.relu(o.bn(o.conv(x, f"{p}.conv1", 2), f"{p}.bn1")), 3, 2, 1)
    out = []
    for name, n in (("res2", 3), ("layer2", 4), ("layer3", 6)):
        for i in range(n):
            x = _bottleneck(o, x, f"{p}.{name}.{i}", 2 if i == 0 and name != "res2" else 1)
        out.append(x)
    f4, f8, f16 = out
    return f16, f8, f4


def key_projection(o, f16, need_s: bool):
    """-> key, shrinkage (None unless ``need_s``), selection."""
    p = "key_proj"
    s = o.conv(f16, f"{p}.d_proj") ** 2 + 1 if need_s else None
    return o.conv(f16, f"{p}.key_proj"), s, torch.sigmoid(o.conv(f16, f"{p}.e_proj"))


def _res_block(o, g, p):
    out = o.conv(F.relu(o.conv(F.relu(g), f"{p}.conv1")), f"{p}.conv2")
    if f"{p}.downsample.weight" in o.sd:
        g = o.conv(g, f"{p}.downsample")
    return out + g


def _cbam(o, x, p):
    c = f"{p}.ChannelGate.mlp"

    def mlp(t):
        return o.linear(F.relu(o.linear(t.flatten(1), f"{c}.1")), f"{c}.3")

    H, W = x.shape[-2:]
    att = mlp(F.avg_pool2d(x, (H, W), stride=(H, W))) + mlp(
        F.max_pool2d(x, (H, W), stride=(H, W)))
    x = x * torch.sigmoid(att)[:, :, None, None]
    pooled = torch.cat([torch.max(x, 1)[0][:, None], torch.mean(x, 1)[:, None]], 1)
    return x * torch.sigmoid(o.conv(pooled, f"{p}.SpatialGate.spatial.conv"))


def _fusion(o, x, g, p):
    g = _res_block(o, torch.cat([x, g], 1), f"{p}.block1")
    r = _cbam(o, g, f"{p}.attention")
    return _res_block(o, g + r, f"{p}.block2")


def _gru(values, h, hd):
    forget = torch.sigmoid(values[:, :hd])
    update = torch.sigmoid(values[:, hd:2 * hd])
    new = torch.tanh(values[:, 2 * hd:])
    return forget * h * (1 - update) + update * new


def value_encoder(o, image, f16, h, mask, hd: int):
    """(value g16, the deep-updated sensory memory)."""
    p = "value_encoder"
    g = torch.cat([image, mask, torch.zeros_like(mask)], 1)
    g = F.relu(F.max_pool2d(o.bn(o.conv(g, f"{p}.conv1", 2), f"{p}.bn1"), 3, 2, 1))
    for li in (1, 2, 3):
        for i in range(2):
            g = _basic(o, g, f"{p}.layer{li}.{i}", 2 if i == 0 and li > 1 else 1)
    g = _fusion(o, f16, g, f"{p}.fuser")
    values = o.conv(torch.cat([g, h], 1), f"{p}.hidden_reinforce.transform")
    return g, _gru(values, h, hd)


def _upsample(x, ratio):
    return F.interpolate(x, scale_factor=ratio, mode="bilinear", align_corners=False)


def decoder(o, f16, f8, f4, h, readout, h_out: bool, hd: int):
    """-> (the updated sensory memory or None, logits at 1/4, logits x4)."""
    p = "decoder"
    g16 = _fusion(o, f16, torch.cat([readout, h], 1), f"{p}.fuser")
    g8 = _res_block(o, o.conv(f8, f"{p}.up_16_8.skip_conv") + _upsample(g16, 2),
                    f"{p}.up_16_8.out_conv")
    g4 = _res_block(o, o.conv(f4, f"{p}.up_8_4.skip_conv") + _upsample(g8, 2),
                    f"{p}.up_8_4.out_conv")
    logits4 = o.conv(F.relu(g4), f"{p}.pred")
    new_h = None
    if h_out:
        u = f"{p}.hidden_update"

        def down(t, ratio):
            return F.interpolate(t, scale_factor=ratio, mode="area")

        g = (o.conv(g16, f"{u}.g16_conv") + o.conv(down(g8, 1 / 2), f"{u}.g8_conv")
             + o.conv(down(torch.cat([g4, logits4], 1), 1 / 4), f"{u}.g4_conv"))
        new_h = _gru(o.conv(torch.cat([g, h], 1), f"{u}.transform"), h, hd)
    return new_h, logits4, _upsample(logits4, 4)


def aggregate(prob):
    """(1, H, W) -> (2, H, W) with the background (``aggregate``)."""
    new = torch.cat([torch.prod(1 - prob, 0, keepdim=True), prob], 0).clamp(CLAMP, 1 - CLAMP)
    return F.softmax(torch.log(new / (1 - new)), 0)


# --------------------------------------------------------------- frames ---

def _resized(h: int, w: int, size: int) -> tuple:
    if min(h, w) == size:
        return h, w
    return (size, int(size * w / h)) if h <= w else (int(size * h / w), size)


def _pad16(x):
    h, w = x.shape[-2:]
    nh = h + (16 - h % 16) % 16
    nw = w + (16 - w % 16) % 16
    lh, uh = (nh - h) // 2, (nh - h) - (nh - h) // 2
    lw, uw = (nw - w) // 2, (nw - w) - (nw - w) // 2
    return F.pad(x, (lw, uw, lh, uh)), (lw, uw, lh, uh)


def prepare(image, size: int, mask=None):
    """eval.py's frame: (H, W, 3) uint8 RGB -> (1, 3, H', W') normalised,
    resized (shorter side ``size``, bilinear) and padded to multiples of
    16; the mask (H, W) -> (1, 1, H', W') (nearest); and the padding."""
    x = torch.as_tensor(image).permute(2, 0, 1).float() / 255.0
    mean = torch.tensor(IM_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IM_STD, device=x.device)[:, None, None]
    x = ((x - mean) / std)[None]
    shape = _resized(x.shape[-2], x.shape[-1], size)
    if shape != tuple(x.shape[-2:]):
        x = F.interpolate(x, size=shape, mode="bilinear", align_corners=False)
    x, pad = _pad16(x)
    m = None
    if mask is not None:
        m = (torch.as_tensor(mask) > 0).float()[None, None].to(x.device)
        if shape != tuple(m.shape[-2:]):
            m = F.interpolate(m, size=shape, mode="nearest")
        m = _pad16(m)[0]
    return x, m, pad


def finish(prob, pad, hw) -> torch.Tensor:
    """eval.py's mask of a step's (2, H', W') probabilities: unpadded,
    resized back to ``hw`` (bilinear), the argmax (the background on a
    tie): (H, W) bool."""
    lw, uw, lh, uh = pad
    prob = prob[:, lh:prob.shape[1] - uh, lw:prob.shape[2] - uw]
    if tuple(prob.shape[-2:]) != tuple(hw):
        prob = F.interpolate(prob[None], size=tuple(hw), mode="bilinear",
                             align_corners=False)[0]
    return torch.argmax(prob, 0) == 1


# --------------------------------------------------------------- memory ---

def similarity(o, mk, ms, qk, qe):
    """``get_similarity``: memory keys (C, N), shrinkage (1, N); query keys
    and selection (C, Q) -> (N, Q)."""
    ck = mk.shape[0]
    mk = mk.transpose(0, 1)
    a_sq = o.mm(mk.pow(2), qe)
    two_ab = 2 * o.mm(mk, qk * qe)
    b_sq = (qe * qk.pow(2)).sum(0, keepdim=True)
    return (-a_sq + two_ab - b_sq) * ms.transpose(0, 1) / math.sqrt(ck)


def top_k_affinity(sim, k: int):
    """``do_softmax`` with top-k: each query's k largest (a stable sort:
    the lower index first among ties), softmaxed (less their maximum),
    scattered into a dense (N, Q) affinity."""
    k = min(k, sim.shape[0])
    vals, idx = torch.sort(sim, dim=0, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    x = torch.exp(vals - vals[:1])
    x = x / x.sum(0, keepdim=True)
    return torch.zeros_like(sim).scatter_(0, idx, x)


class Store:
    """``KeyValueMemoryStore`` for one object group: keys ``k`` (C, N),
    shrinkage ``s`` (1, N), selection ``e`` (C, N; the working memory's
    only), values ``v`` (C_v, N), ``use`` and ``life`` counts (1, N)."""

    def __init__(self, d: dict | None = None):
        d = d or {}
        self.k, self.s, self.e, self.v = (d.get(n) for n in ("k", "s", "e", "v"))
        self.use, self.life = d.get("use"), d.get("life")

    @property
    def size(self) -> int:
        return 0 if self.k is None else self.k.shape[1]

    def add(self, key, value, shrink, sel):
        n = key.shape[1]
        use = torch.zeros(1, n, device=key.device)
        life = torch.zeros(1, n, device=key.device) + NEW_LIFE
        if self.k is None:
            self.k, self.v, self.s, self.e, self.use, self.life = key, value, shrink, sel, use, life
            return
        self.k = torch.cat([self.k, key], -1)
        self.v = torch.cat([self.v, value], -1)
        self.s = torch.cat([self.s, shrink], -1)
        if sel is not None:
            self.e = torch.cat([self.e, sel], -1)
        self.use = torch.cat([self.use, use], -1)
        self.life = torch.cat([self.life, life], -1)

    def update_usage(self, usage):
        self.use = self.use + usage.view_as(self.use)
        self.life = self.life + 1

    def usage(self):
        return self.use / self.life

    def sieve(self, start: int, end: int):
        """Keep what lies outside [start, end) (``sieve_by_range``; ``end``
        0: to the end)."""
        def cut(t):
            if t is None:
                return None
            return t[:, :start] if end == 0 else torch.cat([t[:, :start], t[:, end:]], -1)

        self.k, self.s, self.e, self.v = cut(self.k), cut(self.s), cut(self.e), cut(self.v)
        self.use, self.life = cut(self.use), cut(self.life)

    def remove_obsolete(self, max_size: int):
        """Evict the ``size - max_size`` elements of least use over life
        (the lower index first among ties); returns their indices."""
        order = torch.sort(self.usage()[0], stable=True)[1]
        out = order[:self.size - max_size]
        keep = torch.sort(order[self.size - max_size:])[0]
        for name in ("k", "s", "e", "v", "use", "life"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t[:, keep])
        return out


class MemoryManager:
    """``MemoryManager`` for one object, long-term memory on, from a state
    (``lt``/``wm`` stores as ``Store`` takes them, or none)."""

    def __init__(self, w: dict, hw: int, state: dict | None = None):
        self.w, self.hw = w, hw
        state = state or {}
        self.work = Store(state.get("wm"))
        self.long = Store(state.get("lt"))
        self.prototypes = None
        self.evicted = None

    def match(self, o, qk, qe):
        """The readout (C_v, Q); the usage counted."""
        lt = self.long.size
        if lt:
            mk = torch.cat([self.long.k, self.work.k], -1)
            ms = torch.cat([self.long.s, self.work.s], -1)
        else:
            mk, ms = self.work.k, self.work.s
        aff = top_k_affinity(similarity(o, mk, ms, qk, qe), self.w["top_k"])
        usage = aff.sum(1)
        self.work.update_usage(usage[lt:])
        if lt:
            self.long.update_usage(usage[:lt])
        mv = torch.cat([self.long.v, self.work.v], -1) if lt else self.work.v
        return o.mm(mv, aff)

    def add(self, o, key, shrink, value, sel):
        self.work.add(key, value, shrink, sel)
        w, hw = self.w, self.hw
        if self.work.size >= w["max_mid_term_frames"] * hw:
            limit = w["max_long_term_elements"] - w["num_prototypes"]
            if self.long.size >= limit:
                self.evicted = self.long.remove_obsolete(limit)
            self.compress(o)

    def compress(self, o):
        w, hw = self.w, self.hw
        start, end = hw, -w["min_mid_term_frames"] * hw + hw
        sl = slice(start, None if end == 0 else end)
        ck, cs, ce = self.work.k[:, sl], self.work.s[:, sl], self.work.e[:, sl]
        usage = self.work.usage()[:, sl]
        cv = self.work.v[:, sl]
        idx = torch.sort(usage[0], descending=True, stable=True)[1][:w["num_prototypes"]]
        self.prototypes = idx
        pk, pe = ck[:, idx], ce[:, idx]
        sim = similarity(o, ck, cs, pk, pe)
        aff = F.softmax(sim, dim=0)
        pv = o.mm(cv, aff)
        ps = o.mm(cs, aff)
        self.work.sieve(start, end if end != 0 else 0)
        self.long.add(pk, pv, ps, None)

    def state(self) -> dict:
        def d(s, sel):
            out = {"k": s.k, "s": s.s, "v": s.v, "use": s.use, "life": s.life}
            if sel:
                out["e"] = s.e
            return out

        return {"lt": d(self.long, False), "wm": d(self.work, True)}


# ----------------------------------------------------------------- step ---

def empty_state() -> dict:
    """A fresh session: no memory yet."""
    return {"ti": -1, "last_mem_ti": 0, "hidden": None}


def step(sd: dict, state: dict, x, mask=None, w: dict = XMEM, precision: str = "ref") -> dict:
    """``InferenceCore.step`` on a prepared frame ``x`` (1, 3, H, W) and mask
    (1, 1, H, W) or None (``prepare``) from ``state`` (``empty_state``, or
    the counters, ``hidden`` and both stores of a step; not modified).
    Returns the step's ``prob`` (2, H, W), ``readout``, ``logits4``,
    ``logits`` (after the first frame), ``value`` and ``hidden`` (memory
    frames), ``prototypes`` and ``evicted`` (a consolidation), ``n_lt``,
    ``n_wm`` and the next ``state``."""
    o = _Ops(sd, precision)
    hd = w["hidden_dim"]
    ti = state["ti"] + 1
    last_mem = state["last_mem_ti"]
    if ti == 0 and mask is None:
        raise ValueError("the first frame needs a mask")
    is_mem = ti - last_mem >= w["mem_every"] or mask is not None
    out = {}
    with _matmul_precision(precision), _without_cudnn(), torch.no_grad():
        f16, f8, f4 = key_encoder(o, x)
        key, shrink, sel = key_projection(o, f16, is_mem)
        h, wd = key.shape[-2:]
        mem = MemoryManager(w, h * wd, {k: _clone(state.get(k)) for k in ("lt", "wm")}
                            if "wm" in state else None)
        hidden = (torch.zeros(1, hd, h, wd, device=x.device) if state["hidden"] is None
                  else state["hidden"].clone())
        qk, qe = key[0].flatten(1), sel[0].flatten(1)
        prob = None
        if ti > 0:
            readout = mem.match(o, qk, qe).view(1, -1, h, wd)
            new_h, logits4, logits = decoder(o, f16, f8, f4, hidden, readout, not is_mem, hd)
            if new_h is not None:
                hidden = new_h
            prob = aggregate(torch.sigmoid(logits[0]))
            out.update(readout=readout, logits4=logits4, logits=logits)
        if mask is not None:
            prob = aggregate(mask[0])
        if is_mem:
            value, hidden = value_encoder(o, x, f16, hidden, prob[1:][None], hd)
            out.update(value=value, hidden=hidden)
            mem.add(o, qk, shrink[0].flatten(1), value[0].flatten(1), qe)
            last_mem = ti
    out.update(prob=prob, prototypes=mem.prototypes, evicted=mem.evicted,
               n_lt=mem.long.size, n_wm=mem.work.size,
               state={"ti": ti, "last_mem_ti": last_mem, "hidden": hidden, **mem.state()})
    return out


def _clone(d):
    if d is None:
        return None
    return {k: (v.clone() if v is not None else None) for k, v in d.items()} if d.get(
        "k") is not None and d["k"].shape[1] else None
