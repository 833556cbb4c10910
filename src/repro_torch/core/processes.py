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

Every family of the reference package is here: the closed-form ones
(exponential, deterministic, (truncated) Gaussian, Weibull, log-normal,
Pareto), Gamma by Marsaglia–Tsang rejection from the explicit generator,
batch arrivals (in-batch gaps exactly 0), custom samplers
(``fn(generator, shape, device)``) and empirical resampling; then the
non-stationary arrivals, which yield *absolute timestamps* through
:class:`ArrivalTimeProcess` for the engines' ``prestamped`` mode: NHPP
thinning against a :class:`RateProfile` (:class:`PiecewiseConstantRate`,
:class:`SinusoidalRate`), the two-phase MMPP and exact trace replay.
Timestamps are built and sorted in f64; the staging layer casts them to
f32 once, after the sort.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

_EPS = 1e-9  # service/inter-arrival times are clamped strictly positive

# Inert-arrival sentinel of absolute-timestamp streams: a timestamp past the
# horizon changes nothing but the clock, so thinning rejections map here.
# Finite, so the f32 kernels carry it without inf/nan arithmetic.
PAD_TIME = 1e30


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
class GammaSimProcess(SimProcess):
    """Gamma(k, scale) by Marsaglia–Tsang rejection (:func:`standard_gamma_`)."""

    shape_k: float
    scale: float

    def _fill(self, out, generator):
        standard_gamma_(out, self.shape_k, generator).mul_(self.scale)

    def mean(self):
        return self.shape_k * self.scale

    def with_rate(self, rate):
        return dataclasses.replace(self, scale=1.0 / (float(rate) * self.shape_k))


def standard_gamma_(out: torch.Tensor, k: float, generator) -> torch.Tensor:
    """Fill ``out`` in place with Gamma(k, 1) draws from ``generator``.

    Marsaglia–Tsang: with ``d = k' - 1/3`` and ``c = 1/sqrt(9d)``, draw
    ``x ~ N(0, 1)`` and ``u ~ U(0, 1)``, set ``v = (1 + c x)^3`` and accept
    ``d v`` when ``v > 0`` and ``log u < x^2/2 + d - d v + d log v``; the
    entries still pending are drawn again, round after round, until every
    one is accepted (over 95% are in each round).  For ``k < 1`` the draw
    is made at ``k' = k + 1`` and boosted by ``u^(1/k)``.  (``torch.
    _standard_gamma`` takes no generator, so it cannot serve seeded runs.)
    """
    if not k > 0:
        raise ValueError(f"Gamma shape must be > 0, got {k}")
    kk = k + 1.0 if k < 1.0 else float(k)
    d = kk - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    f = dict(dtype=out.dtype, device=out.device)
    res = torch.empty((out.numel(),), **f)
    pending = torch.arange(out.numel(), device=out.device)
    while pending.numel():
        m = pending.numel()
        x = torch.randn((m,), generator=generator, **f)
        u = torch.rand((m,), generator=generator, **f)
        v = (1.0 + c * x) ** 3
        # v <= 0 gives log(v) = nan or -inf, which the v > 0 test rejects
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        res[pending[ok]] = d * v[ok]
        pending = pending[~ok]
    if k < 1.0:
        res.mul_(_uniform_open(torch.empty_like(res), generator).pow_(1.0 / k))
    return out.copy_(res.view(out.shape))


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


@dataclasses.dataclass(frozen=True)
class BatchArrivalProcess(SimProcess):
    """Batch arrivals: groups of ``batch_size`` requests arrive together.

    Gaps are drawn from ``base`` at the batch heads (every ``batch_size``-th
    entry of the flattened buffer) and are exactly 0 inside a batch: the
    clamp at ``_EPS`` applies to the heads only."""

    base: SimProcess
    batch_size: int

    def sample_into(self, out, generator):
        # a nested batch's zeros that land on a head are clamped, as the
        # reference does
        self.base.sample_into(out, generator)
        idx = torch.arange(out.numel(), device=out.device).view(out.shape)
        return out.clamp_min_(_EPS).masked_fill_(idx % self.batch_size != 0, 0.0)

    def mean(self):
        return self.base.mean() / self.batch_size

    def with_rate(self, rate):
        return dataclasses.replace(
            self, base=self.base.with_rate(float(rate) / self.batch_size)
        )


@dataclasses.dataclass(frozen=True)
class CustomSimProcess(SimProcess):
    """Escape hatch: wrap any ``fn(generator, shape, device) -> samples``
    (paper: users can pass a random generator function with a custom
    distribution).  ``fn`` draws from the :class:`torch.Generator` it is
    given, on ``device``; ``mean_value`` sizes the step budget."""

    fn: Callable
    mean_value: float

    def __hash__(self):  # the callable keeps the dataclass hashable
        return hash((id(self.fn), self.mean_value))

    def _fill(self, out, generator):
        out.copy_(torch.as_tensor(self.fn(generator, tuple(out.shape), out.device)))

    def mean(self):
        return self.mean_value


@dataclasses.dataclass(frozen=True)
class EmpiricalSimProcess(SimProcess):
    """Bootstrap service-time process: resample measured durations (the
    paper's alternative to fitting a parametric distribution)."""

    durations: tuple

    def __post_init__(self):
        d = np.asarray(self.durations, dtype=np.float64)
        if len(d) < 1 or (d <= 0).any():
            raise ValueError("durations must be positive and non-empty")

    def _fill(self, out, generator):
        d = torch.tensor(np.asarray(self.durations, np.float32), device=out.device)
        idx = torch.randint(0, d.numel(), tuple(out.shape), generator=generator,
                            device=out.device)
        out.copy_(d[idx])

    def mean(self):
        return float(np.mean(self.durations))

    def with_rate(self, rate):
        # every duration scaled by one factor: the bootstrap mean lands on
        # 1/rate and the empirical shape is kept
        f = (1.0 / float(rate)) / self.mean()
        return dataclasses.replace(
            self, durations=tuple(float(d) * f for d in self.durations)
        )


# ---------------------------------------------------------------------------
# Non-stationary arrivals: rate profiles, NHPP thinning, timestamp streams
# ---------------------------------------------------------------------------


class ArrivalTimeProcess:
    """Mixin for arrival processes that yield *absolute timestamps*.

    The engines detect this interface and run the kernels ``prestamped``:
    each event carries its arrival clock instead of a gap.  This is what
    makes exact trace replay and non-stationary (NHPP, MMPP) arrivals
    expressible; neither has i.i.d. gaps.

    ``arrival_times(generator, shape, device) -> (times, coverage)``:

    * ``times``: f64 ``shape`` tensor on ``device``, non-decreasing along
      the last axis; entries that carry no arrival are ``PAD_TIME``;
    * ``coverage``: f64 ``shape[:-1]`` tensor, the time up to which the
      stream is exact.  The staging layer raises if a row's coverage is
      below its horizon: a padded stream ends in ``PAD_TIME``, so its last
      timestamp cannot tell.

    Every draw comes from the one ``generator`` (the draw cell's arrival
    stream), in a fixed order.
    """

    def arrival_times(self, generator, shape, device=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RateProfile:
    """Time-varying arrival-rate profile r(t) for non-stationary workloads.

    Subclasses implement ``rate(t)`` on tensors (f64 out, on ``t``'s
    device) and a constant upper bound ``max_rate()`` (the thinning
    envelope lambda_max).
    """

    def rate(self, t) -> torch.Tensor:
        raise NotImplementedError

    def max_rate(self) -> float:
        raise NotImplementedError

    def with_rate(self, rate: float) -> "RateProfile":
        """A copy rescaled so the *time-averaged* rate is ``rate``; the
        shape (relative bin heights, waveform) is kept."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support rate rescaling"
        )

    def block(self) -> tuple:
        """The profile as the f64 parameter block the fused f64 engine
        evaluates (:func:`block_rate`; ``csrc/scan_event_step.cu``'s
        ``profile_rate``): its kind id, then its parameters."""
        raise ValueError(
            f"{type(self).__name__} does not lower to a fused profile block; "
            "use draws='staged'"
        )


# profile block kinds (RateProfile.block): a sinusoid [1, base, amplitude,
# period, phase]; piecewise constant [2, E, edges[E], rates[E+1]]
PROFILE_SINUSOID = 1
PROFILE_PIECEWISE = 2


def block_rate(block, t) -> torch.Tensor:
    """``rate(t)`` of the profile lowered to ``block`` (a tuple of floats,
    :meth:`RateProfile.block`) on the f64 tensor ``t``: the profile's own
    ``rate``, the same f64 value, with no copy to the device and no read
    back (so it can run inside a CUDA graph).  A piecewise profile takes
    ``rates[#(edges <= t)]``, one select per edge."""
    b = [float(x) for x in block]
    kind = int(b[0])
    if kind == PROFILE_SINUSOID:
        base, amp, period, phase = b[1:5]
        # a true division (torch's CUDA division by a host scalar multiplies
        # by its reciprocal instead)
        period = torch.full_like(t, period)
        return base * (1.0 + amp * torch.sin(2.0 * math.pi * t / period + phase))
    if kind == PROFILE_PIECEWISE:
        E = int(b[1])
        rate = torch.full_like(t, b[2 + E])
        for k, edge in enumerate(b[2:2 + E]):  # ascending: the last edge <= t wins
            rate = torch.where(t >= edge, b[3 + E + k], rate)
        return rate
    raise ValueError(f"unknown profile block kind {kind}")


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class PiecewiseConstantRate(RateProfile):
    """r(t) = rates[k] on [edges[k-1], edges[k]) with edges[-1] = +inf.

    ``edges`` are the K interior boundaries (ascending, > 0); ``rates`` has
    K+1 entries, the first applying from t=0: the shape of real-trace rate
    fits (e.g. hourly invocation counts).
    """

    edges: tuple
    rates: tuple

    def __post_init__(self):
        e = np.asarray(self.edges, dtype=np.float64)
        r = np.asarray(self.rates, dtype=np.float64)
        if len(r) != len(e) + 1:
            raise ValueError("need len(rates) == len(edges) + 1")
        if len(e) and ((np.diff(e) <= 0).any() or e[0] <= 0):
            raise ValueError("edges must be positive and strictly increasing")
        if (r <= 0).any():
            raise ValueError("rates must be positive")

    def rate(self, t):
        t = _f64(t)
        edges = torch.tensor(self.edges, dtype=torch.float64, device=t.device)
        rates = torch.tensor(self.rates, dtype=torch.float64, device=t.device)
        return rates[torch.searchsorted(edges, t.contiguous(), right=True)]

    def max_rate(self):
        return float(max(self.rates))

    def block(self):
        return ((float(PROFILE_PIECEWISE), float(len(self.edges)))
                + tuple(float(e) for e in self.edges) + tuple(float(r) for r in self.rates))

    def mean_rate(self) -> float:
        """Time-averaged rate over the covered span: bins weighted by their
        widths, the open last bin by the mean finite-bin width (exact for
        fitted profiles, whose bins are uniform); with no interior edges,
        the single rate."""
        r = np.asarray(self.rates, dtype=np.float64)
        if len(self.edges) == 0:
            return float(r[0])
        e = np.asarray(self.edges, dtype=np.float64)
        widths = np.diff(np.concatenate([[0.0], e]))
        widths = np.concatenate([widths, [widths.mean()]])
        return float((r * widths).sum() / widths.sum())

    def with_rate(self, rate):
        if not rate > 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        f = float(rate) / self.mean_rate()
        return dataclasses.replace(
            self, rates=tuple(float(r) * f for r in self.rates)
        )

    @classmethod
    def fit(
        cls,
        timestamps,
        bin_width: float,
        rate_floor: float = 1e-9,
        n_bins: Optional[int] = None,
    ) -> "PiecewiseConstantRate":
        """Estimate a profile from recorded arrival timestamps: per-bin
        counts over ``bin_width`` become per-bin rates (the trace ->
        profile -> what-if loop).

        ``timestamps`` must be a 1-D, finite, non-negative, sorted array;
        a violation raises ``ValueError`` naming the first offending index.
        Empty bins clamp to ``rate_floor`` (rates feed the thinning
        envelope and must stay positive); the last bin's rate extends past
        the last edge.  ``n_bins`` pins the bin count (timestamps binned
        over ``[0, n_bins * bin_width)``; one at or past that span is
        refused), so re-fits keep one profile shape.
        """
        ts = np.asarray(timestamps, dtype=np.float64)
        if ts.ndim != 1 or len(ts) < 1:
            raise ValueError(
                "need a 1-D array of >= 1 arrival timestamps, got shape "
                f"{ts.shape}"
            )
        if not np.isfinite(ts).all():
            bad = int(np.flatnonzero(~np.isfinite(ts))[0])
            raise ValueError(
                f"timestamps must be finite; timestamps[{bad}] = {ts[bad]}"
            )
        if (ts < 0).any():
            bad = int(np.flatnonzero(ts < 0)[0])
            raise ValueError(
                f"timestamps must be >= 0; timestamps[{bad}] = {ts[bad]}"
            )
        diffs = np.diff(ts)
        if (diffs < 0).any():
            bad = int(np.flatnonzero(diffs < 0)[0]) + 1
            raise ValueError(
                "timestamps must be sorted ascending; timestamps"
                f"[{bad}] = {ts[bad]} < timestamps[{bad - 1}] = {ts[bad - 1]}"
            )
        if not bin_width > 0:
            raise ValueError(f"bin_width must be positive, got {bin_width}")
        if not rate_floor > 0:
            raise ValueError(
                f"rate_floor must be positive (rates feed the thinning "
                f"envelope), got {rate_floor}"
            )
        if n_bins is None:
            # half-open bin membership [k·w, (k+1)·w), like metric windows
            n_bins = int(np.floor(ts.max() / bin_width)) + 1
        else:
            n_bins = int(n_bins)
            if n_bins < 1:
                raise ValueError(f"n_bins must be >= 1, got {n_bins}")
            if ts.max() >= n_bins * bin_width:
                raise ValueError(
                    f"timestamps must lie in [0, n_bins * bin_width) = "
                    f"[0, {n_bins * bin_width}); max is {ts.max()}"
                )
        counts, _ = np.histogram(ts, bins=n_bins, range=(0.0, n_bins * bin_width))
        rates = np.maximum(counts / bin_width, rate_floor)
        edges = np.arange(1, n_bins) * bin_width
        return cls(edges=tuple(float(e) for e in edges),
                   rates=tuple(float(r) for r in rates))


@dataclasses.dataclass(frozen=True)
class SinusoidalRate(RateProfile):
    """Diurnal profile r(t) = base * (1 + amplitude * sin(2*pi*t/period + phase)).

    ``amplitude`` in [0, 1) keeps the rate strictly positive.
    """

    base: float
    amplitude: float
    period: float
    phase: float = 0.0

    def __post_init__(self):
        if not (0.0 <= self.amplitude < 1.0):
            raise ValueError("amplitude must be in [0, 1)")
        if self.base <= 0 or self.period <= 0:
            raise ValueError("base rate and period must be positive")

    def rate(self, t):
        return block_rate(self.block(), _f64(t))

    def max_rate(self):
        return self.base * (1.0 + self.amplitude)

    def block(self):
        return (float(PROFILE_SINUSOID), float(self.base), float(self.amplitude),
                float(self.period), float(self.phase))

    def with_rate(self, rate):
        # the time-averaged rate over a full period is exactly ``base``
        if not rate > 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        return dataclasses.replace(self, base=float(rate))


def _no_gaps(process) -> None:
    raise NotImplementedError(
        f"{type(process).__name__} arrivals have no stationary gap "
        "distribution; the engines consume them through arrival_times() "
        "(the prestamped path)"
    )


def _thin(cand, u, lam, rate_at):
    """Accept candidate ``t`` when ``u * lam <= r(t)``; the rejected map to
    ``PAD_TIME``, and one ascending sort compacts the accepted to the front."""
    return torch.where(u * lam <= rate_at, cand, PAD_TIME).sort(dim=-1).values


@dataclasses.dataclass(frozen=True)
class NHPPArrivalProcess(SimProcess, ArrivalTimeProcess):
    """Non-homogeneous Poisson arrivals with intensity ``profile.rate(t)``.

    Vectorised thinning (Lewis & Shedler): the whole candidate stream comes
    from a homogeneous Poisson at the envelope lambda_max =
    ``profile.max_rate()`` (f64 exponential gaps, an f64 cumsum), each
    candidate is accepted with probability r(t)/lambda_max, and one sort
    compacts the accepted times to the front (:func:`_thin`).

    ``mean()`` is the *candidate* mean gap 1/lambda_max, so that
    ``steps_needed`` sizes the candidate buffer, which is what covering
    the horizon needs.
    """

    profile: RateProfile

    def mean(self):
        return 1.0 / self.profile.max_rate()

    def with_rate(self, rate):
        """Re-level the profile to a time-averaged ``rate`` (its shape kept)."""
        return dataclasses.replace(self, profile=self.profile.with_rate(rate))

    def _fill(self, out, generator):
        _no_gaps(self)

    def draw_spec(self):
        # fused NHPP: candidate gaps at the envelope rate, thinned inline at
        # each candidate's clock (the f64 engine only)
        return "nhpp", (self.profile.max_rate(),)

    def arrival_times(self, generator, shape, device=None):
        lam = self.profile.max_rate()
        f64 = dict(dtype=torch.float64, device=device)
        cand = torch.empty(tuple(shape), **f64).exponential_(1.0, generator=generator)
        cand = cand.div_(lam).cumsum_(dim=-1)
        u = torch.rand(tuple(shape), generator=generator, **f64)
        return _thin(cand, u, lam, self.profile.rate(cand)), cand[..., -1].clone()


@dataclasses.dataclass(frozen=True)
class MMPPArrivalProcess(SimProcess, ArrivalTimeProcess):
    """Two-phase Markov-modulated Poisson process (bursty arrivals).

    The intensity alternates between ``rate_low`` and ``rate_high``,
    switching phase at exponential(``switch_rate``) epochs, starting low:
    the simulator-side counterpart of :func:`repro_torch.data.workload.
    mmpp_arrivals`.  Sampled as thinning against a random per-row rate
    function: each row draws its own switch schedule (a cumsum of
    exponential gaps, as many as candidates), candidates come from a
    homogeneous Poisson at ``rate_high``, and the phase at a candidate is
    the parity of the switches before it (one batched ``searchsorted``
    over every row's own schedule).

    ``mean()`` is the candidate gap ``1/rate_high``; coverage is the
    earlier of the candidate and the switch schedule's ends.
    """

    rate_low: float
    rate_high: float
    switch_rate: float

    def __post_init__(self):
        if self.rate_low <= 0 or self.rate_high <= 0 or self.switch_rate <= 0:
            raise ValueError("MMPP rates must be positive")
        if self.rate_high < self.rate_low:
            raise ValueError("need rate_high >= rate_low (thinning envelope)")

    def mean(self):
        return 1.0 / self.rate_high

    def _fill(self, out, generator):
        _no_gaps(self)

    @staticmethod
    def phase_high(switch_times, t) -> torch.Tensor:
        """True where ``t`` lies in the high phase (an odd number of
        switches before it), for rows of ascending switch epochs."""
        return torch.searchsorted(switch_times, t, right=True) % 2 == 1

    def arrival_times(self, generator, shape, device=None):
        shape = tuple(shape)
        lam, n = self.rate_high, shape[-1]
        f64 = dict(dtype=torch.float64, device=device)
        cand = torch.empty(shape, **f64).exponential_(1.0, generator=generator)
        cand = cand.div_(lam).cumsum_(dim=-1)
        sw = torch.empty(shape, **f64).exponential_(1.0, generator=generator)
        sw = sw.div_(self.switch_rate).cumsum_(dim=-1)
        u = torch.rand(shape, generator=generator, **f64)
        high = self.phase_high(sw.reshape(-1, n), cand.reshape(-1, n)).view(shape)
        rate_at = torch.where(high, self.rate_high, self.rate_low)
        return _thin(cand, u, lam, rate_at), torch.minimum(cand[..., -1], sw[..., -1])


@dataclasses.dataclass(frozen=True)
class TraceArrivalProcess(SimProcess, ArrivalTimeProcess):
    """Replay recorded arrival timestamps (the paper's workflow: measure a
    workload on the real platform, feed the trace to the simulator).

    ``arrival_times`` (the engines' prestamped path) gives the recorded
    timestamps exactly, in f64, the same stream on every row (only the
    service draws differ between replicas); coverage ``inf``.  Past the
    end of the trace it loops, with a wrap gap equal to the mean gap (the
    rate stays stationary).
    """

    timestamps: tuple  # non-decreasing arrival times

    def __post_init__(self):
        ts = np.asarray(self.timestamps, dtype=np.float64)
        if len(ts) < 2:
            raise ValueError("trace needs >= 2 arrivals")
        if (np.diff(ts) < 0).any():
            raise ValueError("trace timestamps must be non-decreasing")

    def _gaps(self) -> np.ndarray:
        ts = np.asarray(self.timestamps, dtype=np.float64)
        gaps = np.diff(ts)
        return np.concatenate([[ts[0] if ts[0] > 0 else gaps.mean()], gaps])

    def _cycle(self) -> np.ndarray:
        """One replay cycle: the trace gaps, then the mean-gap wrap."""
        gaps = self._gaps()
        return np.concatenate([gaps, [max(gaps.mean(), 1e-9)]])

    def _fill(self, out, generator):
        _no_gaps(self)

    def arrival_times(self, generator, shape, device=None):
        *lead, n = tuple(shape)
        cycle = self._cycle()
        times = np.cumsum(np.tile(cycle, int(np.ceil(n / len(cycle)))))[:n]
        # the first cycle is the recorded timestamps exactly (its first gap
        # is the recorded time to the first arrival)
        ts = np.asarray(self.timestamps, dtype=np.float64)
        if ts[0] > 0:
            times[: len(ts)] = ts[: min(len(ts), n)]
        out = torch.from_numpy(times).to(device).expand(*lead, n)
        return out, torch.full(tuple(lead), math.inf, dtype=torch.float64, device=device)

    def mean(self):
        return float(self._gaps().mean())


# every family of the reference package, by class name (interop lookup)
FAMILIES = {
    cls.__name__: cls
    for cls in (
        ExpSimProcess,
        DeterministicSimProcess,
        GaussianSimProcess,
        WeibullSimProcess,
        GammaSimProcess,
        LogNormalSimProcess,
        ParetoSimProcess,
        BatchArrivalProcess,
        CustomSimProcess,
        EmpiricalSimProcess,
        NHPPArrivalProcess,
        MMPPArrivalProcess,
        TraceArrivalProcess,
    )
}
# the rate profiles, by class name
PROFILES = {cls.__name__: cls for cls in (PiecewiseConstantRate, SinusoidalRate)}
