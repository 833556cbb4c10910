"""Carry the reference package's scenarios and sample buffers across.

For a simulator the "weights" are the scenario and the staged sample
buffers.  :func:`scenario_from_reference` builds a port :class:`Scenario`
from a reference one, duck-typed on class names and dataclass fields (it
imports nothing of the reference).  :func:`staged_from_reference` turns
the reference's per-draw-cell ``(dts, warms, colds)`` arrays into the
``staged=`` triple that :func:`~repro_torch.core.scenario.run` and
:func:`~repro_torch.core.scenario.sweep` consume instead of drawing.
:func:`fleet_from_reference` and :func:`fleet_staged_from_reference` do
the same for fleets: a reference ``FleetScenario`` and the merged stream
of its ``_stage_fleet``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cost import BillingModel
from repro_torch.core.fleet import FleetFunction, FleetScenario
from repro_torch.core.processes import FAMILIES, unported
from repro_torch.core.scenario import Scenario


def _fields(obj) -> dict:
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected a dataclass instance, got {type(obj).__name__}")
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def process_from_reference(obj):
    """The port process of the reference process ``obj`` (same family, same
    parameters); a family not ported yet raises ``NotImplementedError``."""
    cls = FAMILIES.get(type(obj).__name__)
    if cls is None:
        unported(type(obj).__name__)
    ref = _fields(obj)
    return cls(**{f.name: float(ref[f.name]) for f in dataclasses.fields(cls)})


def scenario_from_reference(obj) -> Scenario:
    """A port :class:`Scenario` equal field by field to the reference one."""
    if type(obj).__name__ != "Scenario":
        raise TypeError(f"expected a reference Scenario, got {type(obj).__name__}")
    ref = _fields(obj)
    kw = {}
    for f in dataclasses.fields(Scenario):
        v = ref.get(f.name, f.default)
        if f.name.endswith("_process") and v is not None:
            v = process_from_reference(v)
        elif f.name == "billing":
            v = BillingModel(**_fields(v))
        kw[f.name] = v
    return Scenario(**kw)


def staged_from_reference(parts, device=None) -> tuple:
    """``parts`` is the reference's list of per-draw-cell ``(dts, warms,
    colds)`` arrays, each ``[R, K]``, in draw-cell order; returns the three
    f32 ``[D*R, K]`` tensors (on ``device``, default the CPU)."""
    parts = list(parts)
    if not parts or any(len(p) != 3 for p in parts):
        raise ValueError("parts must be a non-empty list of (dts, warms, colds)")
    return tuple(
        torch.from_numpy(
            np.ascontiguousarray(
                np.concatenate([np.asarray(p[j], np.float32) for p in parts])
            )
        ).to(device or "cpu")
        for j in range(3)
    )


def fleet_from_reference(obj) -> FleetScenario:
    """A port :class:`FleetScenario` equal field by field to the reference
    one; its processes go through :func:`process_from_reference`."""
    if type(obj).__name__ != "FleetScenario":
        raise TypeError(f"expected a reference FleetScenario, got {type(obj).__name__}")
    ref = _fields(obj)
    fns = []
    for fn in ref["functions"]:
        if type(fn).__name__ != "FleetFunction":
            raise TypeError(f"expected a reference FleetFunction, got {type(fn).__name__}")
        kw = _fields(fn)
        for name in ("arrival_process", "warm_service_process", "cold_service_process"):
            if kw[name] is not None:
                kw[name] = process_from_reference(kw[name])
        fns.append(FleetFunction(**kw))
    ref["functions"] = tuple(fns)
    ref["billing"] = BillingModel(**_fields(ref["billing"]))
    return FleetScenario(**ref)


def fleet_staged_from_reference(staged, device=None) -> dict:
    """The port's fleet ``staged=`` input from the reference's
    ``_stage_fleet`` dict (``times``, ``fids``, ``warms``, ``colds``, each
    ``[R, K]``, and ``prestamped``): times cast to f32 after the merge (the
    reference's f64 absolute times, or f32 gaps for one function), fids as
    uint8, on ``device`` (default the CPU)."""
    dev = device or "cpu"
    f32 = lambda k: torch.from_numpy(
        np.ascontiguousarray(np.asarray(staged[k]), dtype=np.float32)
    ).to(dev)
    fids = np.asarray(staged["fids"])
    if fids.size and (fids.min() < 0 or fids.max() > 255):
        raise ValueError("fids must be function indices in [0, 255]")
    return dict(
        times=f32("times"),
        fids=torch.from_numpy(np.ascontiguousarray(fids, dtype=np.uint8)).to(dev),
        warms=f32("warms"),
        colds=f32("colds"),
        prestamped=bool(staged["prestamped"]),
    )
