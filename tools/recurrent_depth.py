#!/usr/bin/env python3
"""How the recurrent archs' end-to-end logits drift with depth, on one GPU.

    python3 tools/recurrent_depth.py        # from the root of a checkout

``mamba2-2.7b`` and ``recurrentgemma-9b`` at full width (random bf16
weights from seed 0), cut in depth to the first segment's pattern repeated
r times and at full depth, under ``chip_smoke.py``'s traffic (batch 4 x
2,048-token prompts, 128 teacher-forced decode steps, ``max_len`` 4,096).
At each depth it prints the relative L2 distance of the logits (over batch
and vocab, at the prefill and at each decode step) and the share of equal
argmaxes for two pairs:

* kernels vs plain: the CUDA kernels against ``kernel_backend("ref")``;
* plain vs plain: the plain versions in the kernels' tiling (the SSD scan
  in 64-token chunks, prefill attention in 64-tiles) against the plain
  versions at the model's own, two correct roundings of the same model.

``chip_smoke.py`` holds the kernels-vs-plain logits at the deepest cut
where the plain pair stays well under its limit (``RECURRENT_E2E_REPS``).
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# pattern repetitions read per arch; None is the full depth
DEPTHS = {"mamba2-2.7b": (1, 2, 4, 8, 16, 32, None),
          "recurrentgemma-9b": (1, 2, 4, 8, None)}
KIND_OF = (("ssd_scan", "ssm"), ("rglru_scan", "rglru"), ("flash_attention", "local"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("recurrent_depth: no CUDA device is visible", file=sys.stderr)
        return 1
    card = cs.gpu_line()
    print(card, flush=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models.model import build_model

    _build.build_all(("flash_attention", "decode_attention", "ssd_scan", "rglru_scan"))
    dev = torch.device("cuda", 0)
    for arch, depths in DEPTHS.items():
        full = get_config(arch)
        rng = np.random.default_rng(801)
        draw = lambda n: torch.from_numpy(rng.integers(0, full.vocab_size, (cs.SERVE_BATCH, n)))
        tokens, feed = draw(cs.SERVE_PROMPT).to(dev), draw(cs.SERVE_NEW).to(dev)
        pattern = full.segments[0][0]
        for reps in depths:
            cfg = full if reps is None else dataclasses.replace(
                full, n_layers=reps * len(pattern), segments=((pattern, reps),))
            kinds = [k for p, n in cfg.segments for _ in range(n) for k in p]
            per_prefill = {name: kinds.count(kind) for name, kind in KIND_OF if kind in kinds}
            per_step = {"decode_attention": kinds.count("local")} if "local" in kinds else {}
            t0 = time.perf_counter()
            model = build_model(cfg, seed=0, device=dev)
            lk, _, _ = cs.teacher_forced(torch, ops, model, tokens, feed, None,
                                         per_prefill, per_step)
            lr, _, _ = cs.teacher_forced(torch, ops, model, tokens, feed, "ref", {}, {})
            lt = cs.plain_retiled(torch, model, tokens, feed)
            if not all(bool(torch.isfinite(x).all()) for x in (lk, lr, lt)):
                raise AssertionError(f"{arch} at {cfg.n_layers} layers: logits not finite")
            row = dict(arch=arch, reps=reps, layers=cfg.n_layers)
            for pair, (a, b) in (("kernels_vs_plain", (lk, lr)), ("plain_vs_plain", (lt, lr))):
                rel, agree = cs.logit_distance(torch, a, b)
                row[pair] = dict(prefill=float(rel[0]), decode_max=float(rel[1:].max()),
                                 decode_mean=float(rel[1:].mean()), argmax_agreement=agree)
            row["seconds"] = time.perf_counter() - t0
            kp, pp = row["kernels_vs_plain"], row["plain_vs_plain"]
            print(f"{arch} {cfg.n_layers} layers ({'full' if reps is None else reps} x "
                  f"{pattern}) [{card}]: kernels vs plain prefill {kp['prefill']:.3e}, decode "
                  f"max {kp['decode_max']:.3e} mean {kp['decode_mean']:.3e}, argmax "
                  f"{kp['argmax_agreement']:.4f}; plain vs plain prefill {pp['prefill']:.3e}, "
                  f"decode max {pp['decode_max']:.3e} mean {pp['decode_mean']:.3e}, argmax "
                  f"{pp['argmax_agreement']:.4f}; {row['seconds']:.1f} s", flush=True)
            del model, lk, lr, lt
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
