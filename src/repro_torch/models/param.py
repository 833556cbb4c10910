"""Parameter initialisation from an explicit :class:`torch.Generator`.

The port of ``repro/models/param.py::ParamBuilder`` in its ``init`` mode,
with the same distributions: ``normal`` is N(0, 1) times ``scale``
(default ``1/sqrt(fan_in)``, fan-in the second-to-last dimension),
``embed`` is N(0, 0.02²), ``uniform_dt`` is U(0, 1), ``zeros`` and
``ones`` are constant.  Values are drawn in f32 on the generator's device
and then cast to the leaf's ``dtype`` (default the builder's): the builders
pass ``dtype=torch.float32`` for the few leaves the reference reads in f32
whatever the compute dtype.

A builder without a generator draws nothing: it returns empty ``meta``
tensors of each leaf's shape and dtype, the tree that
:func:`repro_torch.models.model.cast_params` casts a carried-across tree
to.  The reference's sharding specs have no counterpart here.  The numbers
differ from ``jax.random``'s: tests carry the reference's parameters across
with :func:`repro_torch.interop.params_from_reference`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

INITS = ("normal", "embed", "uniform_dt", "zeros", "ones")


@dataclasses.dataclass
class ParamBuilder:
    generator: Optional[torch.Generator]  # None: shape-only, on the meta device
    dtype: torch.dtype = torch.float32

    @property
    def device(self) -> torch.device:
        return torch.device("meta") if self.generator is None else self.generator.device

    def param(
        self,
        shape: Sequence[int],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        dtype = dtype or self.dtype
        if init not in INITS:
            raise ValueError(f"unknown init {init}")
        if self.generator is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "uniform_dt":
            x = torch.rand(shape, generator=self.generator, dtype=torch.float32,
                           device=self.device)
            return x.to(dtype)
        if init == "embed":
            scale = 0.02
        elif scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return x.mul_(scale).to(dtype)
