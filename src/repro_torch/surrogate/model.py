"""NN surrogate of §3: symmetric 1D-CNN encoder/decoder around LSTM layers.

Estimates the 3-component surface velocity waveform at an observation point
from the 3-component bedrock input wave, capturing 3-D nonlinear
amplification.  Architecture per the paper: n_c strided conv encoder →
n_lstm LSTM layers in latent space → n_c transposed-conv decoder whose
final layer splits into three independent per-component groups.  MAE loss.

Plain functions over nested-dict params with the JAX package's leaf names
(``enc``/``lstm``/``dec``/``heads`` lists of ``w``/``b`` or ``wx``/``wh``/
``b``), so each package loads the other's saved surrogates.  Weights keep
the reference's layouts: conv ``w [K, Cin, Cout]`` (``WIO``), LSTM ``wx
[Cin, 4H]``, ``wh [H, 4H]`` with gates in the order i, f, g, o.  fp32.

Two of the reference's convolutions have no direct torch call: XLA's
``SAME`` padding of a strided convolution (:func:`_conv1d` pads by hand)
and ``lax.conv_transpose``, which does not flip its kernel
(:func:`_conv1d_transpose` dilates the input and runs a stride-1
convolution with the unflipped weight).  On the card every convolution of
the surrogate runs in full fp32 with deterministic algorithms
(:func:`exact_convs`), so card and CPU agree to fp32 tolerances and two
runs on the same batches give the same params.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.stream import pad_kset, leaves_in_insertion_order, tree_map
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    n_c: int = 2              # conv encoder/decoder depth (search {2,3,4})
    n_lstm: int = 2           # LSTM layers (search {1,2,3})
    kernel: int = 9           # conv kernel (search {3,5,9,17,33,65})
    latent: int = 64          # latent width (paper: up to 1024; tests small)
    in_ch: int = 3
    out_ch: int = 3
    lr: float = 1.75e-4       # paper's tuned value as default


def _conv_init(gen, k, cin, cout):
    scale = (2.0 / (k * cin)) ** 0.5
    return scale * torch.randn((k, cin, cout), generator=gen, dtype=torch.float32)


def init_params(cfg: SurrogateConfig, generator: torch.Generator, *, device=None) -> dict[str, Any]:
    """He-normal weights drawn from ``generator`` (a CPU generator, so the
    draw is the same for every device), zero biases, on ``device``
    (``None``: the card)."""
    dev = resolve_device(device)
    z = lambda n: torch.zeros((n,), dtype=torch.float32)  # noqa: E731
    p: dict[str, Any] = {"enc": [], "dec": [], "lstm": []}
    cin = cfg.in_ch
    for i in range(cfg.n_c):
        cout = cfg.latent if i == cfg.n_c - 1 else max(cfg.latent // 2, 8)
        p["enc"].append({"w": _conv_init(generator, cfg.kernel, cin, cout), "b": z(cout)})
        cin = cout
    for _ in range(cfg.n_lstm):
        H = cfg.latent
        p["lstm"].append({
            "wx": _conv_init(generator, 1, cin, 4 * H)[0],
            "wh": _conv_init(generator, 1, H, 4 * H)[0],
            "b": z(4 * H),
        })
        cin = H
    for i in range(cfg.n_c):
        cout = max(cfg.latent // 2, 8)
        p["dec"].append({"w": _conv_init(generator, cfg.kernel, cin, cout), "b": z(cout)})
        cin = cout
    # final decoder layer: three independent per-component conv heads
    p["heads"] = [{"w": _conv_init(generator, cfg.kernel, cin, 1), "b": z(1)}
                  for _ in range(cfg.out_ch)]
    return tree_map(lambda t: t.to(dev), p)


_EXACT_LOCK = threading.Lock()
_exact: list = []  # the flags' context while some thread is inside exact_convs, and how many are


@contextlib.contextmanager
def exact_convs():
    """cuDNN in full fp32 (no TF32) with deterministic algorithms and no
    autotuning: the surrogate's forward and backward run under it.  No-op
    for CPU tensors.  cuDNN's flags are global: the first thread in sets
    them and the last one out restores them, so the replicas of a sharded
    engine (one host thread each) all convolve under them."""
    with _EXACT_LOCK:
        if not _exact:
            ctx = torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
            ctx.__enter__()
            _exact[:] = [ctx, 0]
        _exact[1] += 1
    try:
        yield
    finally:
        with _EXACT_LOCK:
            _exact[1] -= 1
            if _exact[1] == 0:
                _exact.pop(0).__exit__(None, None, None)
                _exact.clear()


def _conv1d(x, w, b, stride=1):
    """x [B,T,C] ⊛ w [K,Cin,Cout] with XLA's ``SAME`` padding: ⌈T/s⌉
    outputs, the padding split with its smaller half on the left."""
    K, T = w.shape[0], x.shape[1]
    out = -(-T // stride)
    total = max((out - 1) * stride + K - T, 0)
    xt = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(xt, w.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + b


def _conv1d_transpose(x, w, b, stride=2):
    """``lax.conv_transpose(x, w, (stride,), "SAME")`` for x [B,T,C], w
    [K,Cin,Cout] → [B, T·stride, Cout]: the input dilated with stride−1
    zeros, padded as XLA pads it, then a stride-1 convolution with the
    weight as it is (``F.conv_transpose1d`` would flip it)."""
    B, T, C = x.shape
    K, s = w.shape[0], stride
    pad_a = K - 1 if s > K - 1 else -(-(K + s - 2) // 2)
    pad_b = K + s - 2 - pad_a
    xt = F.pad(x.transpose(1, 2).unsqueeze(-1), (0, s - 1)).reshape(B, C, T * s)  # s−1 zeros after each
    xt = F.pad(xt, (pad_a, pad_b - (s - 1)))  # the last element's trailing zeros count toward pad_b
    y = F.conv1d(xt, w.permute(2, 1, 0))
    return y.transpose(1, 2) + b


def _lstm_layer(p, x):
    """x [B,T,C] → [B,T,H] (single direction): a plain loop over time with
    the input projection taken out of it as one product."""
    H = p["wh"].shape[0]
    B = x.shape[0]
    xw = torch.matmul(x, p["wx"]) + p["b"]  # [B,T,4H]
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    hs = []
    for xw_t in xw.unbind(1):  # unbind: one stack in the backward, not T zero-filled slices
        gates = torch.addmm(xw_t, h, p["wh"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def apply(params, cfg: SurrogateConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B,T,3] input wave → ŷ [B,T,3] response waveform."""
    with exact_convs():
        h = x
        for layer in params["enc"]:
            h = F.gelu(_conv1d(h, layer["w"], layer["b"], stride=2), approximate="tanh")
        for layer in params["lstm"]:
            h = _lstm_layer(layer, h)
        for layer in params["dec"]:
            h = F.gelu(_conv1d_transpose(h, layer["w"], layer["b"], stride=2), approximate="tanh")
        h = torch.cat([_conv1d(h, hd["w"], hd["b"]) for hd in params["heads"]], dim=-1)
    # transposed convs restore T exactly when T % 2**n_c == 0
    return h[:, : x.shape[1]]


def mae_loss(params, cfg, x, y):
    pred = apply(params, cfg, x)
    return (pred - y).abs().mean()


# ---------------------------------------------------------------------------
# batch-shape-stable inference entry point (shared by serving and the
# trainer's validation path, so the two can never drift on preprocessing)
# ---------------------------------------------------------------------------

PREDICT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def pick_bucket(n: int, buckets=PREDICT_BUCKETS) -> int:
    """Smallest bucket ≥ ``n``; above the largest, the next multiple of it.

    The shape policy of :func:`predict`: any batch size maps onto a small,
    fixed set of batch shapes, so a row's result does not depend on which
    other requests share its batch."""
    buckets = sorted(buckets)
    if n < 1:
        raise ValueError(f"batch must be ≥ 1, got {n}")
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def check_params_on(params, dev: torch.device) -> None:
    """Refuse a param tree that does not live on ``dev`` (a CPU tensor
    names no index: ``cpu:0`` is the CPU)."""
    where = leaves_in_insertion_order(params)[0].device
    if where.type != dev.type or (dev.type == "cuda" and dev.index is not None and where.index != dev.index):
        raise ValueError(f"params live on {where}, not on {dev}: move them first")


@torch.no_grad()
def predict(params, cfg: SurrogateConfig, x, *, buckets=PREDICT_BUCKETS, device=None) -> torch.Tensor:
    """Forward pass with canonical pad-to-bucket + mask preprocessing on
    ``device`` (``None``: the card), where ``params`` must live.

    ``x [B,T,3] → ŷ [B,T,3]`` (numpy or a tensor).  The batch axis is
    padded up to a :func:`pick_bucket` size with repeats of the last row
    (``core/stream.pad_kset`` — padded lanes stay numerically well-behaved
    and are masked off the result); the time axis is zero-padded to a
    multiple of ``2**n_c`` so the strided encoder / transposed decoder
    round-trip restores ``T`` exactly.  The serving engine and the
    trainer's validation path both go through here, so serving and
    training share one preprocessing definition and one set of shapes.
    """
    dev = resolve_device(device)
    check_params_on(params, dev)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if x.ndim != 3:
        raise ValueError(f"predict expects x [B,T,C], got shape {tuple(x.shape)}")
    B, T = x.shape[0], x.shape[1]
    pad_t = (-T) % (2 ** cfg.n_c)
    if pad_t:
        x = F.pad(x, (0, 0, 0, pad_t))
    x, _valid = pad_kset(x, pick_bucket(B, buckets))
    return apply(params, cfg, x)[:B, :T]
