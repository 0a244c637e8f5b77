"""Parallel-in-time trajectory surrogate: a diagonal-linear state-space
sequence model trained through a logarithmic-depth scan.

The CNN+LSTM surrogate (:mod:`repro_torch.surrogate.model`) removes the FEM
cost per query, but its LSTM core is still O(T) sequential depth.  Every
layer here mixes time through the **input-dependent diagonal-linear
recurrence**

    h_t = a_t ⊙ h_{t-1} + b_t,        a_t = exp(Δ_t ⊙ A) ∈ (0, 1)

which is associative, so the whole history resolves in ⌈log₂ T⌉ doubling
steps (:func:`ssm_scan`; the Mamba/S5 selective-SSM recipe).  The same
recurrence replayed one step at a time is the **O(1)-state streaming
decode** (:func:`step`): a serving engine holds one ``[B, H, N]`` state per
layer and maps bedrock-wave samples to response samples as they arrive.

Three execution paths, one set of params:

``apply(..., scan="assoc")``   training/full-sequence — O(log T) depth;
``apply(..., scan="seq")``     the loop over time (tolerance oracle for
                               the doubling path);
``step``                       O(1)-state recurrence through the same
                               block functions as the sequential path.

The JAX package's ``surrogate/seqmodel.py`` with the same param tree
(leaf names ``enc``/``layers``/``out``), fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.stream import pad_kset, tree_map
from repro_torch.device import resolve_device
from repro_torch.models.layers import rmsnorm
from repro_torch.surrogate.model import PREDICT_BUCKETS, check_params_on, pick_bucket


@dataclasses.dataclass(frozen=True)
class TrajectoryConfig:
    """Shape of the trajectory surrogate.

    ``latent``     channel width H of the residual stream;
    ``state``      diagonal SSM state size N per channel (h is [H, N]);
    ``n_layers``   stacked selective-SSM blocks;
    ``obs_every``  trajectory stride: the model maps the bedrock wave
                   *downsampled by this stride* onto the equally-strided
                   observation series the campaign harvested
                   (``dataset.generate(trajectories=True, obs_every=k)``);
    ``lr``         Adam step size for :func:`repro_torch.surrogate.
                   trajectory.fit_trajectory`.
    """

    latent: int = 32
    state: int = 8
    n_layers: int = 2
    in_ch: int = 3
    out_ch: int = 3
    obs_every: int = 1
    lr: float = 3e-4

    def __post_init__(self):
        if self.obs_every < 1:
            raise ValueError(f"obs_every must be ≥ 1, got {self.obs_every}")


def _dense_init(gen, cin, cout):
    return ((2.0 / cin) ** 0.5) * torch.randn((cin, cout), generator=gen, dtype=torch.float32)


def init_params(cfg: TrajectoryConfig, generator: torch.Generator, *, device=None) -> dict[str, Any]:
    """Weights drawn from ``generator`` (a CPU generator), on ``device``
    (``None``: the card)."""
    dev = resolve_device(device)
    H, N = cfg.latent, cfg.state
    p: dict[str, Any] = {
        "enc": {"w": _dense_init(generator, cfg.in_ch, H), "b": torch.zeros((H,))},
        "layers": [],
        "out": {"w": _dense_init(generator, H, cfg.out_ch), "b": torch.zeros((cfg.out_ch,))},
    }
    for _ in range(cfg.n_layers):
        p["layers"].append({
            # A in (-16, -1): stable decays spread over timescales
            "A_log": torch.log(torch.linspace(1.0, 16.0, N))[None, :].repeat(H, 1),
            "w_dt": _dense_init(generator, H, H),
            "dt_bias": torch.full((H,), math.log(math.expm1(1e-1))),
            "w_B": _dense_init(generator, H, N),
            "w_C": _dense_init(generator, H, N),
            "w_g": _dense_init(generator, H, H),
            "D": torch.ones((H,)),
            "norm": torch.ones((H,)),
        })
    return tree_map(lambda t: t.to(dev), p)


# ---------------------------------------------------------------------------
# the scan core: h_t = a_t ⊙ h_{t-1} + b_t, two ways
# ---------------------------------------------------------------------------


def _fold_h0(a, b, h0):
    """Fold an initial state into the first element: b'_0 = a_0·h_0 + b_0."""
    if h0 is None:
        return b
    return torch.cat([(b[:, 0] + a[:, 0] * h0).unsqueeze(1), b[:, 1:]], dim=1)


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All states of ``h_t = a_t ⊙ h_{t-1} + b_t`` in ⌈log₂ T⌉ steps.

    ``a, b [B, T, ...]`` (time axis 1) → ``h [B, T, ...]``.  Hillis–Steele
    doubling under the composition ``(a₂, b₂) ∘ (a₁, b₁) = (a₁·a₂,
    a₂·b₁ + b₂)``: after the step of offset d, element t holds the
    composition of elements t−2d+1 … t.  Tolerance-equal (not bit-equal:
    the products are reassociated) to :func:`ssm_scan_ref`."""
    b = _fold_h0(a, b, h0)
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        if 2 * d < T:  # the last step's products are not read
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The O(T)-depth loop for :func:`ssm_scan` — exactly the arithmetic
    :func:`step` replays one step at a time."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    hs = []
    for a_t, b_t in zip(a.unbind(1), b.unbind(1)):
        h = a_t * h + b_t
        hs.append(h)
    return torch.stack(hs, dim=1)


SCANS = ("assoc", "seq")


# ---------------------------------------------------------------------------
# the selective-SSM block
# ---------------------------------------------------------------------------


def _layer_ab(p, v):
    """Input-dependent recurrence coefficients of one block.

    ``v [..., H]`` (pre-normed stream) → ``(a, b) [..., H, N]`` plus the
    selective readout ``C [..., N]`` — shared verbatim by the full-sequence
    path and :func:`step` so the two cannot drift."""
    dt = F.softplus(v @ p["w_dt"] + p["dt_bias"])             # [..., H]
    A = -torch.exp(p["A_log"])                                # [H, N]
    a = torch.exp(dt[..., None] * A)                          # [..., H, N]
    Bv = v @ p["w_B"]                                         # [..., N]
    b = (dt * v)[..., None] * Bv[..., None, :]                # [..., H, N]
    C = v @ p["w_C"]                                          # [..., N]
    return a, b, C


def _layer_out(p, v, h, C):
    """State → block output: selective readout + skip, silu-gated."""
    y = (h * C[..., None, :]).sum(-1) + p["D"] * v
    return y * F.silu(v @ p["w_g"])


def apply(params, cfg: TrajectoryConfig, x: torch.Tensor, *, scan: str = "assoc") -> torch.Tensor:
    """Full-sequence forward: wave samples ``x [B, T, in_ch]`` →
    trajectory ``ŷ [B, T, out_ch]`` (same stride as the input — callers
    holding full-rate waves go through :func:`predict`, which applies
    ``cfg.obs_every``).  ``scan`` picks the temporal executor from
    :data:`SCANS`."""
    if scan not in SCANS:
        raise ValueError(f"scan must be one of {SCANS}, got {scan!r}")
    run = ssm_scan if scan == "assoc" else ssm_scan_ref
    u = x @ params["enc"]["w"] + params["enc"]["b"]
    for p in params["layers"]:
        v = rmsnorm(u, p["norm"])
        a, b, C = _layer_ab(p, v)
        h = run(a, b)
        u = u + _layer_out(p, v, h, C)
    return u @ params["out"]["w"] + params["out"]["b"]


def init_state(cfg: TrajectoryConfig, batch: int, *, device=None) -> list[torch.Tensor]:
    """Zero streaming state on ``device`` (``None``: the card): one
    diagonal-SSM state per layer — the whole memory of an in-flight
    trajectory, O(1) in its length."""
    dev = resolve_device(device)
    return [torch.zeros((batch, cfg.latent, cfg.state), dtype=torch.float32, device=dev)
            for _ in range(cfg.n_layers)]


def step(params, cfg: TrajectoryConfig, x_t: torch.Tensor,
         state: list[torch.Tensor]) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """One streaming step: ``x_t [B, in_ch]`` + per-layer states →
    ``(ŷ_t [B, out_ch], new_state)``.

    Replays the sequential recurrence of ``apply(..., scan="seq")`` through
    the same block functions: feeding a wave sample-by-sample reproduces
    the full-sequence output, with memory independent of how long the
    trajectory has been running.  Products over ``[B, H]`` and over ``[B·T,
    H]`` may round differently, so the two agree within 1e-5, not bitwise."""
    u = x_t @ params["enc"]["w"] + params["enc"]["b"]
    new_state = []
    for p, h_prev in zip(params["layers"], state):
        v = rmsnorm(u, p["norm"])
        a, b, C = _layer_ab(p, v)
        h = a * h_prev + b
        new_state.append(h)
        u = u + _layer_out(p, v, h, C)
    return u @ params["out"]["w"] + params["out"]["b"], new_state


def mae_loss(params, cfg: TrajectoryConfig, x, y):
    """MAE over the strided trajectory: ``x`` is the *full-rate* wave as
    harvested (``[B, nt, in_ch]``), ``y`` the ``obs_every``-strided
    observation series — the shard format ``dataset.generate(
    trajectories=True)`` commits."""
    pred = apply(params, cfg, x[:, :: cfg.obs_every])
    return (pred - y[:, : pred.shape[1]]).abs().mean()


# ---------------------------------------------------------------------------
# batch-shape-stable inference entry point (mirrors surrogate.model.predict)
# ---------------------------------------------------------------------------


@torch.no_grad()
def predict(params, cfg: TrajectoryConfig, x, *, buckets=None, scan: str = "assoc",
            device=None) -> torch.Tensor:
    """Full-history prediction with the canonical pad-to-bucket
    preprocessing on ``device`` (``None``: the card), where ``params`` must
    live: full-rate wave ``x [B, nt, in_ch]`` → trajectory ``ŷ [B,
    ⌈nt/obs_every⌉, out_ch]``.

    The batch axis pads to a :func:`repro_torch.surrogate.model.
    pick_bucket` size with repeats of the last row (padded lanes masked
    off), so serving traffic holds one shape per (bucket, nt) — the same
    contract as the CNN surrogate's ``predict``."""
    dev = resolve_device(device)
    check_params_on(params, dev)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if x.ndim != 3:
        raise ValueError(f"predict expects x [B,T,C], got shape {tuple(x.shape)}")
    B = x.shape[0]
    x = x[:, :: cfg.obs_every]
    x, _valid = pad_kset(x, pick_bucket(B, buckets or PREDICT_BUCKETS))
    return apply(params, cfg, x, scan=scan)[:B]
