"""Declarative scenario catalog: what a campaign simulates, as data (numpy
only; the port's own copy of the JAX package's ``scenario/catalog.py``, so
the same spec and seed give bitwise the same waves in both packages).

The paper's §3 dataset is one point in a much larger scenario space — one
wave family (band-limited noise), one soil column, one observation point.
Its companion work (arXiv:2409.20380) and DeepPhysics (arXiv:2109.09491)
both stress that surrogates only generalize when the training ensembles
cover *diverse* input motions and site conditions.  A :class:`Scenario`
makes that coverage declarative and hashable:

* **wave family** (:class:`WaveSpec`) — band-limited noise (the paper's
  §3 input), Ricker wavelets, linear chirp sweeps, pulse-train synthetics;
  every family emits zero-mean, cosine-tapered bedrock velocities so the
  integrated displacement carries no baseline drift;
* **soil profile** (:class:`SoilSpec`) — per-layer multipliers on the
  basin's material properties (V_s, ρ, γ_r, h_max), threaded into
  :func:`repro_torch.fem.meshgen.generate` as perturbed
  :class:`~repro_torch.fem.meshgen.Material` layers;
* **observation points** (:class:`ObsSpec`) — an n×m grid of surface
  nodes instead of the single hand-picked point.

Two scenarios that differ in any physics-bearing field hash differently
(:meth:`Scenario.signature`).  Both packages thread that signature into the
campaign checkpoint signature (the port through
:meth:`repro_torch.scenario.planner.PlanGroup.signature` in ``run_group``), so
a checkpoint written under one scenario refuses to resume under another —
including soil perturbations, which change the mesh but neither the waves
nor the ``SeismicConfig`` the original signature covered.

:meth:`Scenario.compile_key` captures the subset of fields that shape the
campaign's operators and shapes (mesh, physics, observation count, record
length).  Scenarios sharing a compile key run as one campaign over many
rounds: :func:`repro_torch.scenario.planner.make_plan` groups them so, as
the reference's planner does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np

from repro_torch.fem import meshgen

WAVE_FAMILIES = ("band_noise", "ricker", "chirp", "pulse_train")


# ---------------------------------------------------------------------------
# wave synthesis
# ---------------------------------------------------------------------------


def cosine_taper(nt: int, frac: float = 0.05) -> np.ndarray:
    """Tukey window: cosine ramps over ``frac`` of the record at each end."""
    w = np.ones(nt)
    if frac <= 0.0:
        return w
    m = max(1, int(round(frac * nt)))
    if 2 * m >= nt:
        m = nt // 2
    ramp = 0.5 * (1.0 - np.cos(np.pi * (np.arange(m) + 0.5) / m))
    w[:m] = ramp
    w[nt - m:] = ramp[::-1]
    return w


def _finalize(w: np.ndarray, taper_frac: float) -> np.ndarray:
    """Taper then remove the per-case mean (≡ zeroing the rfft DC bin).

    A bedrock input *velocity* with nonzero mean integrates to a linearly
    drifting displacement — pure baseline error.  Every family goes through
    this gate, so ``w.sum(axis=1) == 0`` to fp roundoff for all scenarios.
    """
    w = w * cosine_taper(w.shape[1], taper_frac)[None, :, None]
    return w - w.mean(axis=1, keepdims=True)


@dataclasses.dataclass(frozen=True)
class WaveSpec:
    """One input-motion family + its parameters.

    ``fmax``   band limit [Hz] (band_noise) / sweep end frequency (chirp).
    ``f0``     center frequency (ricker), sweep start (chirp), carrier
               frequency (pulse_train) [Hz].
    ``pulses`` Gaussian-modulated pulses per record (pulse_train).
    """

    family: str = "band_noise"
    fmax: float = 2.5
    f0: float = 1.0
    pulses: int = 3
    amp_xy: float = 0.6
    amp_z: float = 0.3
    taper_frac: float = 0.05

    def __post_init__(self):
        if self.family not in WAVE_FAMILIES:
            raise ValueError(
                f"unknown wave family {self.family!r}; one of {WAVE_FAMILIES}"
            )
        if self.fmax <= 0 or self.f0 <= 0:
            raise ValueError(f"frequencies must be > 0 (fmax={self.fmax}, f0={self.f0})")
        if self.pulses < 1:
            raise ValueError(f"pulses must be ≥ 1, got {self.pulses}")
        if not 0.0 <= self.taper_frac < 0.5:
            raise ValueError(f"taper_frac must be in [0, 0.5), got {self.taper_frac}")

    @property
    def amp(self) -> np.ndarray:
        return np.array([self.amp_xy, self.amp_xy, self.amp_z])

    def synthesize(self, n: int, nt: int, dt: float, seed: int) -> np.ndarray:
        """``[n, nt, 3]`` zero-mean, tapered bedrock velocities (float64)."""
        rng = np.random.default_rng(seed)
        t = np.arange(nt) * dt
        T = nt * dt
        if self.family == "band_noise":
            w = rng.uniform(-1.0, 1.0, size=(n, nt, 3)) * self.amp
            w = w * cosine_taper(nt, self.taper_frac)[None, :, None]
            freqs = np.fft.rfftfreq(nt, dt)
            kill = (freqs > self.fmax) | (freqs == 0.0)  # band limit + DC
            if kill[1:].all():
                # record shorter than 1/fmax: keep the fundamental so a tiny
                # test record is band-limited, not silently all-zero
                kill[1] = False
            W = np.fft.rfft(w, axis=1)
            W[:, kill] = 0.0
            return np.fft.irfft(W, n=nt, axis=1)
        if self.family == "ricker":
            t0 = rng.uniform(0.3, 0.7, size=(n, 1, 1)) * T
            f = self.f0 * rng.uniform(0.8, 1.25, size=(n, 1, 1))
            # floor so the wavelet support (±~0.78/f) fits the record even
            # at test scale — an unfittable Ricker degenerates to a constant
            f = np.maximum(f, 2.6 / T)
            a = (np.pi * f * (t[None, :, None] - t0)) ** 2
            jitter = rng.uniform(0.7, 1.3, size=(n, 1, 3)) * rng.choice(
                [-1.0, 1.0], size=(n, 1, 3)
            )
            w = (1.0 - 2.0 * a) * np.exp(-a) * jitter * self.amp
        elif self.family == "chirp":
            # linear sweep f0 → fmax over the record, random per-case phase
            k = (self.fmax - self.f0) / T
            phase = 2.0 * np.pi * (self.f0 * t + 0.5 * k * t**2)
            phi = rng.uniform(0.0, 2.0 * np.pi, size=(n, 1, 3))
            gain = rng.uniform(0.7, 1.3, size=(n, 1, 3))
            w = np.sin(phase[None, :, None] + phi) * gain * self.amp
        else:  # pulse_train
            f0 = max(self.f0, 5.0 / T)  # same fit-the-record floor
            sigma = 1.0 / (2.0 * f0)
            t0 = rng.uniform(0.15, 0.85, size=(n, self.pulses, 1, 1)) * T
            gain = rng.uniform(0.5, 1.0, size=(n, self.pulses, 1, 3)) * rng.choice(
                [-1.0, 1.0], size=(n, self.pulses, 1, 3)
            )
            dt_p = t[None, None, :, None] - t0
            pulses = np.sin(2.0 * np.pi * f0 * dt_p) * np.exp(-((dt_p / sigma) ** 2))
            w = (pulses * gain).sum(axis=1) * self.amp
        return _finalize(w, self.taper_frac)


# ---------------------------------------------------------------------------
# soil profile perturbations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SoilSpec:
    """Per-layer material-property multipliers over the basin's base layers.

    Tuples are ordered surface → bedrock and must all share one length: 2
    selects the (SOFT, BEDROCK) base column, 3 the (SOFT, MEDIUM, BEDROCK)
    one.  ``vs`` scales V_s *and* V_p together, preserving the Poisson
    ratio (and keeping Lamé λ = ρ(V_p² − 2V_s²) positive for any scale).
    """

    vs: tuple = (1.0, 1.0)
    rho: tuple = (1.0, 1.0)
    gamma_r: tuple = (1.0, 1.0)
    h_max: tuple = (1.0, 1.0)

    def __post_init__(self):
        for f in ("vs", "rho", "gamma_r", "h_max"):
            object.__setattr__(self, f, tuple(float(v) for v in getattr(self, f)))
        lens = {len(getattr(self, f)) for f in ("vs", "rho", "gamma_r", "h_max")}
        if lens != {len(self.vs)} or len(self.vs) not in (2, 3):
            raise ValueError(
                f"soil multiplier tuples must share one length of 2 or 3 "
                f"(layers surface→bedrock); got lengths {sorted(lens)}"
            )
        for f in ("vs", "rho", "gamma_r", "h_max"):
            if any(v <= 0 for v in getattr(self, f)):
                raise ValueError(f"soil multipliers must be > 0 ({f}={getattr(self, f)})")

    @property
    def n_layers(self) -> int:
        return len(self.vs)

    def materials(self) -> list[meshgen.Material]:
        base = (
            [meshgen.SOFT, meshgen.BEDROCK]
            if self.n_layers == 2
            else [meshgen.SOFT, meshgen.MEDIUM, meshgen.BEDROCK]
        )
        out = []
        for i, m in enumerate(base):
            out.append(meshgen.Material(
                rho=m.rho * self.rho[i],
                vs=m.vs * self.vs[i],
                vp=m.vp * self.vs[i],
                gamma_r=m.gamma_r * self.gamma_r[i],
                beta=m.beta,
                h_max=min(0.99, m.h_max * self.h_max[i]),
            ))
        return out


# ---------------------------------------------------------------------------
# observation grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """``grid = (gx, gy)`` surface observation points, uniform over the
    basin surface — each grid target snaps to its nearest surface node
    (deterministic; coarse meshes may map neighbours to one node, which is
    kept so the observation count stays ``gx·gy`` for every mesh)."""

    grid: tuple = (1, 1)

    def __post_init__(self):
        object.__setattr__(self, "grid", tuple(int(g) for g in self.grid))
        if len(self.grid) != 2 or any(g < 1 for g in self.grid):
            raise ValueError(f"obs grid must be (gx≥1, gy≥1), got {self.grid}")

    @property
    def n_obs(self) -> int:
        return self.grid[0] * self.grid[1]

    def indices(self, mesh) -> np.ndarray:
        surf = np.asarray(mesh.surface)
        xy = mesh.coords[surf][:, :2]
        lx, ly = xy[:, 0].max(), xy[:, 1].max()
        gx, gy = self.grid
        out = []
        for i in range(gx):
            for j in range(gy):
                target = np.array([(i + 0.5) / gx * lx, (j + 0.5) / gy * ly])
                out.append(surf[np.argmin(((xy - target) ** 2).sum(axis=1))])
        return np.asarray(out, dtype=surf.dtype)


# ---------------------------------------------------------------------------
# the scenario itself
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One fully-specified ensemble scenario: wave family × soil profile ×
    observation grid × discretization × ensemble shape.

    ``name`` is a label only — it is *excluded* from :meth:`signature`, so
    relabeling a scenario does not invalidate its checkpoints; every other
    field participates.
    """

    name: str = "default"
    wave: WaveSpec = WaveSpec()
    soil: SoilSpec = SoilSpec()
    obs: ObsSpec = ObsSpec()
    mesh_n: tuple = (3, 3, 3)
    n_cases: int = 8
    nt: int = 64
    dt: float = 0.01
    nspring: int = 12
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "mesh_n", tuple(int(n) for n in self.mesh_n))
        if len(self.mesh_n) != 3 or any(n < 1 for n in self.mesh_n):
            raise ValueError(f"mesh_n must be 3 positive cell counts, got {self.mesh_n}")
        if self.n_cases < 1 or self.nt < 4:
            raise ValueError(f"need n_cases ≥ 1 and nt ≥ 4, got {self.n_cases}/{self.nt}")
        if self.dt <= 0:
            raise ValueError(f"dt must be > 0, got {self.dt}")

    # -- identity -----------------------------------------------------------
    def _physics_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("name")
        return d

    def signature(self) -> str:
        """Stable hex digest over every physics-bearing field (not the name)."""
        blob = json.dumps(self._physics_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def compile_key(self) -> str:
        """Digest of the fields that shape the campaign's operators and
        shapes: mesh + soil (they define operators), observation count and
        record length (they define shapes), dt/nspring (physics constants).
        Wave family/params, seed, n_cases are runtime data — scenarios
        differing only there can share one campaign.  The same digest as the
        reference's, so both packages group scenarios alike."""
        key = {
            "mesh_n": self.mesh_n,
            "soil": dataclasses.asdict(self.soil),
            "obs": dataclasses.asdict(self.obs),
            "nt": self.nt,
            "dt": self.dt,
            "nspring": self.nspring,
        }
        return hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]

    # -- realization --------------------------------------------------------
    def waves(self) -> np.ndarray:
        return self.wave.synthesize(self.n_cases, self.nt, self.dt, self.seed)

    def build_mesh(self, pad_elems_to: int = 8):
        return meshgen.generate(
            *self.mesh_n, materials=self.soil.materials(), pad_elems_to=pad_elems_to
        )

    def sim_config(self, *, npart: int = 2, tol: float = 1e-6, maxiter: int = 400,
                   **knobs):
        """The port's :class:`~repro_torch.fem.methods.SeismicConfig`; extra
        ``knobs`` pass straight to it — kernel backend (``backend``/
        ``tile_e``/``tile_p``) and solver amortization (``warm_start``/
        ``precond_every``)."""
        from repro_torch.fem import methods

        return methods.SeismicConfig(
            dt=self.dt, tol=tol, maxiter=maxiter, npart=npart,
            nspring=self.nspring, **knobs
        )


# ---------------------------------------------------------------------------
# named presets
# ---------------------------------------------------------------------------

CATALOG: dict[str, Scenario] = {
    "noise-baseline": Scenario(name="noise-baseline"),
    "ricker-soft-basin": Scenario(
        name="ricker-soft-basin",
        wave=WaveSpec(family="ricker", f0=1.5),
        soil=SoilSpec(vs=(0.8, 1.0), gamma_r=(0.7, 1.0)),
    ),
    "chirp-stiff-shelf": Scenario(
        name="chirp-stiff-shelf",
        wave=WaveSpec(family="chirp", f0=0.5, fmax=3.0),
        soil=SoilSpec(vs=(1.2, 1.1)),
    ),
    "pulse-grid-obs": Scenario(
        name="pulse-grid-obs",
        wave=WaveSpec(family="pulse_train", f0=1.2, pulses=4),
        obs=ObsSpec(grid=(2, 2)),
    ),
}


def get(name: str) -> Scenario:
    try:
        return CATALOG[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; catalog has {sorted(CATALOG)}"
        ) from None
