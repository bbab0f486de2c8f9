"""Failure processes: node hazards (exponential / Weibull) and correlated
cluster-loss events.

Two sampling paths, same distributions:

  * `sample_lifetimes` — one torch call drawing a whole (trials, nodes)
    matrix of i.i.d. lifetimes by inverse-CDF transform on a float32
    `torch.rand` from the caller's `torch.Generator`, on its device
    (CUDA unless the caller asks for the CPU). The Monte Carlo driver uses
    it to seed every trial's initial failure times in a single vectorized
    draw.
  * `Hazard.sample` — per-event numpy draws for replacement nodes inside
    a running trial (the event loop is host-side Python; a device round
    trip per event would dominate).

Weibull shape k < 1 models infant mortality, k = 1 is exactly
exponential (the memoryless regime `core.mttdl` assumes), k > 1 wear-out
— the knob that breaks the Markov model's first assumption. Correlated
cluster loss (power/switch domain failures, CR-SIM's "correlated
failures") breaks the second: every node of one cluster fails at the
same instant.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Hazard:
    """Base lifetime distribution. Subclasses define inverse CDF F⁻¹(u)."""

    def quantile(self, u):
        raise NotImplementedError

    def sample(self, rng: np.random.Generator, size=None):
        """Numpy draw(s) — the per-event path inside a trial."""
        return self.quantile(rng.random(size))

    @property
    def mean_hours(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Exponential(Hazard):
    """Memoryless lifetime, mean = `mean` hours."""
    mean: float

    def quantile(self, u):
        if isinstance(u, torch.Tensor):
            return -self.mean * torch.log1p(-u)
        return -self.mean * np.log1p(-u)

    @property
    def mean_hours(self) -> float:
        return self.mean


@dataclasses.dataclass(frozen=True)
class Weibull(Hazard):
    """Weibull(shape k, scale λ) lifetime in hours.

    shape == 1 reduces to Exponential(scale); mean = scale·Γ(1 + 1/k)."""
    shape: float
    scale: float

    def quantile(self, u):
        if isinstance(u, torch.Tensor):
            return self.scale * (-torch.log1p(-u)) ** (1.0 / self.shape)
        return self.scale * (-np.log1p(-u)) ** (1.0 / self.shape)

    @property
    def mean_hours(self) -> float:
        return self.scale * math.gamma(1.0 + 1.0 / self.shape)


def sample_lifetimes(hazard: Hazard, generator: torch.Generator,
                     shape: tuple[int, ...], *,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """Draw `shape` i.i.d. lifetimes in ONE vectorized torch call.

    Inverse-CDF transform on a float32 uniform(0,1) drawn from
    `generator` on `device` (the generator must live there), evaluated
    there in float32: identical distribution to `hazard.sample`, but
    every trial × node initial lifetime of a Monte Carlo campaign comes
    from a single device draw instead of a Python loop of per-node
    draws. Returns float64 on the host."""
    device = resolve_device(device)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return hazard.quantile(u).cpu().numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Everything stochastic about one simulated deployment.

    node:        per-node lifetime distribution (fresh draw on each
                 replacement — renewal process).
    cluster_loss_mean_hours:
                 mean time between correlated cluster-loss events across
                 the WHOLE deployment (exponential inter-arrivals); each
                 event wipes one uniformly-chosen cluster. None disables
                 correlated failures (the Markov model's regime).
    """
    node: Hazard
    cluster_loss_mean_hours: float | None = None

    def next_cluster_loss(self, rng: np.random.Generator) -> float | None:
        if self.cluster_loss_mean_hours is None:
            return None
        return float(rng.exponential(self.cluster_loss_mean_hours))

    def pick_cluster(self, rng: np.random.Generator, num_clusters: int) -> int:
        return int(rng.integers(num_clusters))


def exponential_from_mttf_years(mttf_years: float) -> Exponential:
    """Node hazard matching §5's λ = 1/(node MTTF)."""
    return Exponential(mean=mttf_years * 24 * 365)
