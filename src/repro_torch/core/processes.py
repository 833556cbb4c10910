"""SimProcess families for the PyTorch port: vectorised samplers that draw
whole ``[R, n]`` sample buffers at once on a chosen device.

A process is a small frozen dataclass.  ``sample(generator, shape, device)``
returns f32 samples clamped strictly positive at ``_EPS``, drawn from an
explicit :class:`torch.Generator` (which must live on ``device``);
``sample_into(out, generator)`` fills a preallocated f32 buffer in place,
so a sweep can stage its ``[C, K]`` buffers without a second copy.
``draw_spec()`` lowers a process to the fused draw path
(:mod:`repro_torch.core.drawplan`): a distribution id and its parameters,
as the reference's families do.

The families ported so far are the stationary closed-form ones:
exponential, deterministic, (truncated) Gaussian, Weibull, Pareto and
log-normal.  The remaining families of the reference package raise
``NotImplementedError`` through :func:`unported` with the ROADMAP item
that brings them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_EPS = 1e-9  # service/inter-arrival times are clamped strictly positive

# reference families this slice does not port yet -> the ROADMAP item
UNPORTED = {
    "GammaSimProcess": "Queue A item 3 (Gamma rejection sampling)",
    "BatchArrivalProcess": "Queue A item 3 (batch arrivals)",
    "CustomSimProcess": "Queue A item 3 (custom sampler callables)",
    "EmpiricalSimProcess": "Queue A item 3 (empirical resampling)",
    "NHPPArrivalProcess": "Queue A item 3 (RateProfile and NHPP thinning)",
    "MMPPArrivalProcess": "Queue A item 3 (MMPP arrivals)",
    "TraceArrivalProcess": "Queue A item 3 (trace replay)",
    "RateProfile": "Queue A item 3 (RateProfile and NHPP thinning)",
    "PiecewiseConstantRate": "Queue A item 3 (RateProfile and NHPP thinning)",
    "SinusoidalRate": "Queue A item 3 (RateProfile and NHPP thinning)",
}


def unported(name: str):
    """Raise the pointed error for a reference family not ported yet."""
    item = UNPORTED.get(name, "Queue A item 3")
    raise NotImplementedError(
        f"{name} is not ported to repro_torch yet; see ROADMAP.md {item}"
    )


@dataclasses.dataclass(frozen=True)
class SimProcess:
    """Base class.  Subclasses implement ``_fill`` and ``mean``."""

    def sample(self, generator, shape, device=None) -> torch.Tensor:
        """Draw ``shape`` i.i.d. samples (f32, strictly positive)."""
        out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        return self.sample_into(out, generator)

    def sample_into(self, out: torch.Tensor, generator) -> torch.Tensor:
        """Fill the f32 buffer ``out`` in place with i.i.d. samples."""
        if out.dtype != torch.float32:
            raise ValueError(f"sample buffers are f32, got {out.dtype}")
        self._fill(out, generator)
        return out.clamp_min_(_EPS)

    def _fill(self, out: torch.Tensor, generator) -> None:
        raise NotImplementedError

    def mean(self) -> float:
        raise NotImplementedError

    def with_rate(self, rate: float) -> "SimProcess":
        """Return a copy rescaled to ``rate`` events per unit time."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support rate rescaling"
        )


def _uniform_open(out, generator):
    # the reference draws u in [1e-12, 1) so log(u) and u**(-1/a) stay finite
    return out.uniform_(1e-12, 1.0, generator=generator)


@dataclasses.dataclass(frozen=True)
class ExpSimProcess(SimProcess):
    """Exponential process with ``rate`` events per unit time."""

    rate: float

    def _fill(self, out, generator):
        out.exponential_(1.0, generator=generator).div_(self.rate)

    def mean(self):
        return 1.0 / self.rate

    def with_rate(self, rate):
        return dataclasses.replace(self, rate=float(rate))

    def draw_spec(self):
        return "exp", (self.rate,)


@dataclasses.dataclass(frozen=True)
class DeterministicSimProcess(SimProcess):
    """Fixed-interval process (e.g. cron-style arrivals)."""

    interval: float

    def _fill(self, out, generator):
        out.fill_(self.interval)

    def mean(self):
        return self.interval

    def with_rate(self, rate):
        return dataclasses.replace(self, interval=1.0 / float(rate))

    def draw_spec(self):
        return "det", (self.interval,)


@dataclasses.dataclass(frozen=True)
class GaussianSimProcess(SimProcess):
    """Gaussian process truncated at ~0 (samples are clamped positive)."""

    mu: float
    sigma: float

    def _fill(self, out, generator):
        out.normal_(0.0, 1.0, generator=generator).mul_(self.sigma).add_(self.mu)

    def mean(self):
        # the nominal mean, as the reference reports it (mu >> sigma)
        return self.mu

    def with_rate(self, rate):
        # mean-preserving rescale keeping the coefficient of variation
        f = (1.0 / float(rate)) / self.mu
        return dataclasses.replace(self, mu=self.mu * f, sigma=self.sigma * f)

    def draw_spec(self):
        return "gauss", (self.mu, self.sigma)


@dataclasses.dataclass(frozen=True)
class WeibullSimProcess(SimProcess):
    """Weibull(k, lambda) by inverse CDF: ``scale * (-log u)**(1/k)``."""

    shape_k: float
    scale: float

    def _fill(self, out, generator):
        _uniform_open(out, generator).log_().neg_().pow_(1.0 / self.shape_k)
        out.mul_(self.scale)

    def mean(self):
        return self.scale * math.gamma(1.0 + 1.0 / self.shape_k)

    def with_rate(self, rate):
        return dataclasses.replace(
            self, scale=1.0 / (float(rate) * math.gamma(1.0 + 1.0 / self.shape_k))
        )

    def draw_spec(self):
        return "weibull", (self.shape_k, self.scale)


@dataclasses.dataclass(frozen=True)
class LogNormalSimProcess(SimProcess):
    mu: float
    sigma: float

    def _fill(self, out, generator):
        out.normal_(0.0, 1.0, generator=generator).mul_(self.sigma).add_(self.mu)
        out.exp_()

    def mean(self):
        return float(math.exp(self.mu + 0.5 * self.sigma**2))

    def with_rate(self, rate):
        # exp(mu + sigma^2/2) = 1/rate, keeping sigma (shape) fixed
        return dataclasses.replace(
            self, mu=float(-math.log(rate) - 0.5 * self.sigma**2)
        )

    def draw_spec(self):
        return "lognorm", (self.mu, self.sigma)


@dataclasses.dataclass(frozen=True)
class ParetoSimProcess(SimProcess):
    """Pareto(alpha, x_m) by inverse CDF: ``x_m / u**(1/alpha)``."""

    alpha: float
    x_m: float

    def _fill(self, out, generator):
        _uniform_open(out, generator).pow_(-1.0 / self.alpha).mul_(self.x_m)

    def mean(self):
        if self.alpha <= 1.0:
            return float("inf")
        return self.alpha * self.x_m / (self.alpha - 1.0)

    def with_rate(self, rate):
        if self.alpha <= 1.0:
            raise ValueError(
                "Pareto with alpha <= 1 has infinite mean; cannot re-rate"
            )
        return dataclasses.replace(
            self, x_m=(self.alpha - 1.0) / (self.alpha * float(rate))
        )

    def draw_spec(self):
        return "pareto", (self.alpha, self.x_m)


# the families this slice ports, by reference class name (interop lookup)
FAMILIES = {
    cls.__name__: cls
    for cls in (
        ExpSimProcess,
        DeterministicSimProcess,
        GaussianSimProcess,
        WeibullSimProcess,
        LogNormalSimProcess,
        ParetoSimProcess,
    )
}
