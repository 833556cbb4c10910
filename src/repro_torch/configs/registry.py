"""Architecture registry of the port: the reference's ids, of which the port
serves the dense attention, Mamba-2 and Griffin models ported so far."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

# archs whose blocks the port serves -> module name
PORTED = {
    "llama3.2-1b": "llama3_2_1b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

# the reference's other archs (repro/configs/registry.py): their block kinds
# (MoE, MLA) or multimodal prefixes are not ported yet
UNPORTED = (
    "granite-8b",
    "gemma-2b",
    "stablelm-12b",
    "paligemma-3b",
    "musicgen-large",
    "llama4-maverick-400b-a17b",
    "deepseek-v3-671b",
)


def _module(arch: str):
    name = PORTED.get(arch)
    if name is None and arch in PORTED.values():
        name = arch
    if name is not None:
        return importlib.import_module(f"repro_torch.configs.{name}")
    if arch in UNPORTED or arch.replace("_", "-") in UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the port serves {sorted(PORTED)}; "
            "the other model families come with ROADMAP.md Queue A item 9b"
        )
    raise KeyError(f"unknown arch {arch!r}; known: {sorted([*PORTED, *UNPORTED])}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).smoke_config()
