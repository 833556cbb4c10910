"""Parameter initialisation from an explicit :class:`torch.Generator`.

The port of ``repro/models/param.py::ParamBuilder`` in its ``init`` mode,
with the same distributions: ``normal`` is N(0, 1) times ``scale``
(default ``1/sqrt(fan_in)``, fan-in the second-to-last dimension),
``embed`` is N(0, 0.02²), ``zeros`` and ``ones`` are constant.  Values are
drawn in f32 on the generator's device and then cast to ``dtype``.  The
reference's sharding specs and shape-only modes have no counterpart here.
The numbers differ from ``jax.random``'s: tests carry the reference's
parameters across with :func:`repro_torch.interop.params_from_reference`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch


@dataclasses.dataclass
class ParamBuilder:
    generator: torch.Generator
    dtype: torch.dtype = torch.float32

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def param(
        self,
        shape: Sequence[int],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        dtype = dtype or self.dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init not in ("normal", "embed"):
            raise ValueError(f"unknown init {init}")
        if init == "embed":
            scale = 0.02
        elif scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return x.mul_(scale).to(dtype)
