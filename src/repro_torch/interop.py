"""Carry the reference package's scenarios and sample buffers across.

For a simulator the "weights" are the scenario and the staged sample
buffers.  :func:`scenario_from_reference` builds a port :class:`Scenario`
from a reference one, duck-typed on class names and dataclass fields (it
imports nothing of the reference).  :func:`staged_from_reference` turns
the reference's per-draw-cell ``(dts, warms, colds)`` arrays (with the
reliability extras of its ``draw_reliability_stream`` and its crash
uniforms) into the ``staged=`` buffers that :func:`~repro_torch.core.scenario.run` and
:func:`~repro_torch.core.scenario.sweep` consume instead of drawing, and
:func:`fused_keys_from_reference` turns the reference's per-draw-cell
fused stream keys into the ``fused_keys=`` that fused runs draw from.
:func:`fleet_from_reference` and :func:`fleet_staged_from_reference` do
the same for fleets: a reference ``FleetScenario`` and the merged stream
of its ``_stage_fleet``.  :func:`params_from_reference` carries a reference
model's parameter tree into the port's layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cost import BillingModel
from repro_torch.core.faults import CapacityProfile, FaultModel
from repro_torch.core.fleet import FleetFunction, FleetScenario
from repro_torch.core.processes import FAMILIES, PROFILES
from repro_torch.core.reliability import FailurePolicy, Reliability, RetryPolicy
from repro_torch.core.scenario import Scenario


def _fields(obj) -> dict:
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected a dataclass instance, got {type(obj).__name__}")
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _value_from_reference(v):
    """One field value of a reference process or profile in the port's
    terms: a nested process or profile converted, a sequence (``edges``,
    ``rates``, ``timestamps``, ``durations``) as a tuple of floats, an int
    kept (``batch_size``), any other number as a float."""
    name = type(v).__name__
    if name in FAMILIES:
        return process_from_reference(v)
    if name in PROFILES:
        return profile_from_reference(v)
    if isinstance(v, (tuple, list, np.ndarray)):
        return tuple(float(x) for x in np.asarray(v, np.float64).ravel())
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return int(v)
    return float(v)


def _convert(obj, table: dict, what: str):
    cls = table.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"expected a reference {what}, got {type(obj).__name__}")
    ref = _fields(obj)
    return cls(**{f.name: _value_from_reference(ref[f.name]) for f in dataclasses.fields(cls)})


def process_from_reference(obj):
    """The port process of the reference process ``obj``: same family, same
    parameters, nested ones (a batch process's ``base``, an NHPP's
    ``profile``) converted too.  A reference ``CustomSimProcess`` wraps a
    JAX callable, which the port cannot call: it raises ``TypeError``."""
    if type(obj).__name__ == "CustomSimProcess":
        raise TypeError(
            "a reference CustomSimProcess wraps a JAX sampler fn(key, shape); "
            "build the port's own repro_torch CustomSimProcess with "
            "fn(generator, shape, device) returning a torch tensor"
        )
    return _convert(obj, FAMILIES, "SimProcess")


def profile_from_reference(obj):
    """The port rate profile of the reference one (same class, same values)."""
    return _convert(obj, PROFILES, "RateProfile")


def reliability_from_reference(obj) -> Reliability:
    """The port :class:`Reliability` equal field by field to the reference
    one (its ``FailurePolicy`` and ``RetryPolicy``)."""
    if type(obj).__name__ != "Reliability":
        raise TypeError(f"expected a reference Reliability, got {type(obj).__name__}")
    ref = _fields(obj)
    return Reliability(
        failure=FailurePolicy(**_fields(ref["failure"])),
        retry=RetryPolicy(**_fields(ref["retry"])),
    )


def faults_from_reference(obj) -> FaultModel:
    """The port :class:`FaultModel` equal field by field to the reference
    one (its crash rate and :class:`CapacityProfile`)."""
    if type(obj).__name__ != "FaultModel":
        raise TypeError(f"expected a reference FaultModel, got {type(obj).__name__}")
    ref = _fields(obj)
    cap = ref["capacity"]
    if cap is not None:
        if type(cap).__name__ != "CapacityProfile":
            raise TypeError(f"expected a reference CapacityProfile, got {type(cap).__name__}")
        cap = CapacityProfile(**_fields(cap))
    return FaultModel(crash_rate=ref["crash_rate"], capacity=cap)


def scenario_from_reference(obj) -> Scenario:
    """A port :class:`Scenario` equal field by field to the reference one
    (its processes, rate profile, billing, reliability policies, fault
    model and window bounds)."""
    if type(obj).__name__ != "Scenario":
        raise TypeError(f"expected a reference Scenario, got {type(obj).__name__}")
    ref = _fields(obj)
    kw = {}
    for f in dataclasses.fields(Scenario):
        v = ref.get(f.name, f.default)
        if f.name.endswith("_process") and v is not None:
            v = process_from_reference(v)
        elif f.name == "rate_profile" and v is not None:
            v = profile_from_reference(v)
        elif f.name == "billing":
            v = BillingModel(**_fields(v))
        elif f.name == "reliability" and v is not None:
            v = reliability_from_reference(v)
        elif f.name == "faults" and v is not None:
            v = faults_from_reference(v)
        kw[f.name] = v
    return Scenario(**kw)


def staged_from_reference(parts, device=None, crash_u=None, f64: bool = False) -> tuple:
    """The port's ``staged=`` buffers from the reference's per-draw-cell
    draws, in draw-cell order: each part is ``(dts, warms, colds)``, or the
    ``(samples, extras)`` pair of the reference's
    ``draw_reliability_stream`` (``extras`` is ``(fail_u,)``, or ``(fail_u,
    is_first, child_pos)`` beside an attempt table's f64 times), each
    array ``[R, K]``; ``crash_u`` optionally gives each draw cell's crash
    uniforms (the reference's ``draw_crash_uniforms``, ``[R, K]`` each),
    which become the last buffer.  Returns the 3, 4 or 6 buffers (one more
    with crashes) as f32 ``[D*R, K]`` tensors (on ``device``, default the
    CPU): times cast after the reference's sort, flags and positions as
    0/1 and exact f32 values.  With ``f64=True`` each buffer keeps the
    reference's own precision for the f64 engine (backends ``"scan"``/
    ``"scan_ref"``): f64 timestamps stay f64, flags bool and positions
    int32; f32 draws stay f32."""
    flat = []
    for p in parts:
        if len(p) == 2 and isinstance(p[0], (tuple, list)):
            p = tuple(p[0]) + tuple(p[1])
        flat.append(tuple(p))
    widths = {len(p) for p in flat}
    if not flat or len(widths) != 1 or widths.pop() not in (3, 4, 6):
        raise ValueError(
            "parts must be a non-empty list of (dts, warms, colds) or of the "
            "reference's (samples, extras), all alike"
        )
    if crash_u is not None:
        if len(crash_u) != len(flat):
            raise ValueError(f"crash_u needs one array per draw cell ({len(flat)})")
        flat = [p + (u,) for p, u in zip(flat, crash_u)]
    def dtype_of(a):
        if not f64:
            return np.float32
        if a.dtype == np.bool_:
            return np.bool_
        if np.issubdtype(a.dtype, np.integer):
            return np.int32
        return np.float64 if a.dtype == np.float64 else np.float32

    out = []
    for j in range(len(flat[0])):
        arrs = [np.asarray(p[j]) for p in flat]
        dt = dtype_of(arrs[0])
        out.append(torch.from_numpy(
            np.ascontiguousarray(np.concatenate([a.astype(dt) for a in arrs]))
        ).to(device or "cpu"))
    return tuple(out)


def fused_keys_from_reference(parts, device=None) -> dict:
    """The port's ``fused_keys=`` from the reference's per-draw-cell
    ``stream_row_keys`` dicts (uint32 ``[R, 2]`` arrays under ``"arrival"``,
    ``"warm"``, ``"cold"`` and, with reliability, ``"fail"``), in draw-cell
    order: one uint32 ``[D*R, 2]`` tensor per stream (on ``device``,
    default the CPU).  The fused bitstream is the contract between the
    packages, so with the same keys both draw the same uniforms: on the
    block engine (backends ``"cuda"``/``"ref"``) and on the f64 engine
    (``"scan"``/``"scan_ref"``, against the reference's fused scan)."""
    parts = [dict(p) for p in parts]
    names = {frozenset(p) for p in parts}
    if not parts or len(names) != 1:
        raise ValueError("parts must be a non-empty list of stream_row_keys dicts, all alike")
    out = {}
    for name in parts[0]:
        arrs = [np.asarray(p[name]) for p in parts]
        if any(a.dtype != np.uint32 or a.ndim != 2 or a.shape[1] != 2 for a in arrs):
            raise ValueError(f"stream {name!r}: keys must be uint32 [R, 2] arrays")
        out[name] = torch.from_numpy(np.ascontiguousarray(np.concatenate(arrs))).to(
            device or "cpu")
    return out


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
        if kw.get("rate_profile") is not None:
            kw["rate_profile"] = profile_from_reference(kw["rate_profile"])
        fns.append(FleetFunction(**kw))
    ref["functions"] = tuple(fns)
    ref["billing"] = BillingModel(**_fields(ref["billing"]))
    if ref.get("faults") is not None:
        ref["faults"] = faults_from_reference(ref["faults"])
    return FleetScenario(**ref)


def fleet_staged_from_reference(staged, device=None) -> dict:
    """The port's fleet ``staged=`` input from the reference's
    ``_stage_fleet`` dict (``times``, ``fids``, ``warms``, ``colds``, each
    ``[R, K]``, and ``prestamped``; with crashes the ``crash_u`` its fleet
    launcher adds): the reference's f64 absolute times kept exactly (the
    front door casts them to the engine's dtype: f32 after the merge for
    the block engine, as the reference's Pallas launcher does, f64 for the
    scan), or its f32 gaps for one function; fids as uint8, on ``device``
    (default the CPU)."""
    dev = device or "cpu"
    f32 = lambda k: torch.from_numpy(np.array(staged[k], dtype=np.float32)).to(dev)
    stamped = bool(staged["prestamped"])
    fids = np.asarray(staged["fids"])
    if fids.size and (fids.min() < 0 or fids.max() > 255):
        raise ValueError("fids must be function indices in [0, 255]")
    out = dict(
        times=(torch.from_numpy(np.array(staged["times"], dtype=np.float64)).to(dev)
               if stamped else f32("times")),
        fids=torch.from_numpy(np.ascontiguousarray(fids, dtype=np.uint8)).to(dev),
        warms=f32("warms"),
        colds=f32("colds"),
        prestamped=stamped,
    )
    if staged.get("crash_u") is not None:
        out["crash_u"] = f32("crash_u")
    return out


def params_from_reference(params_np, cfg, device=None) -> dict:
    """The port's parameter tree (see :mod:`repro_torch.models.model`) from a
    reference model's, as numpy arrays (``jax.device_get(model.init(key))``):
    the segments' stacked ``[count, ...]`` leaves are split into one dict
    per layer, in the order the stack runs them, and every leaf is cast on
    ``device`` (default the CPU) to the dtype the port's builder gives it
    (:func:`repro_torch.models.model.cast_params`): ``cfg.compute_dtype``,
    but f32 for the leaves the reference reads in f32.  The reference keeps
    f32 parameters and casts them to the compute dtype at every use; both
    frameworks cast f32 to bf16 by round-to-nearest-even, so the port
    computes with the same values."""
    from repro_torch.models.model import cast_params
    from repro_torch.models.transformer import check_served, segment_layout

    check_served(cfg)

    def conv(tree, index=None):
        if isinstance(tree, dict):
            return {k: conv(v, index) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree if index is None else np.asarray(tree)[index],
                                         dtype=np.float32))

    segs = params_np["blocks"]
    layout = segment_layout(cfg)
    if len(segs) != len(layout):
        raise ValueError(f"{len(segs)} parameter segments for {len(layout)} config segments")
    blocks = []
    for (pattern, count, _), seg in zip(layout, segs):
        if len(seg) != len(pattern):
            raise ValueError(f"segment {pattern} has {len(seg)} parameter elements")
        for r in range(count):
            blocks.extend(conv(elem, r) for elem in seg)
    out = {k: conv(v) for k, v in params_np.items() if k in ("embed", "head", "final_norm")}
    out["blocks"] = blocks
    unknown = set(params_np) - {"embed", "head", "final_norm", "blocks"}
    if unknown:
        raise NotImplementedError(
            f"reference parameters {sorted(unknown)} have no counterpart in the port yet; "
            "see ROADMAP.md Queue A item 9b"
        )
    return cast_params(out, cfg, device or "cpu")
