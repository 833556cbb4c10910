"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

The port of ``repro/launch/serve.py``.  Boots the scale-per-request platform
around real model replicas on the GPU (``--device cpu`` for the CPU):
measures a replica's cold and warm service times, plans the expiration
threshold with the SimFaaS core (the ``faas_sweep`` kernel) against the
target rate and SLO, replays a Poisson workload and prints
predicted-vs-observed QoS.  The served archs are ``llama3.2-1b``,
``mamba2-2.7b`` and ``recurrentgemma-9b``.  The replica runs at the arch's
published widths (``--width full``, the default: ``llama3.2-1b`` takes
~2.5 GB of bf16 weights on the card, ``mamba2-2.7b`` ~5.5 GB and
``recurrentgemma-9b`` ~21 GB, of which ~3.5 GB are its f32 gate weights) or
at its smoke config (``--width smoke``, which the reference launcher uses
on its host; ``llama3.2-1b``'s smoke head_dim of 16 is below the attention
kernels' 32, so it serves on the CPU only).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def measure(rep, batch: int, prompt_len: int, new_tokens: int, seed: int = 0):
    """(cold_s, warm_s) of a fresh replica: cold = its weight init plus the
    first prefill and decode; warm = one request batch afterwards (prefill
    + ``new_tokens`` greedy decode steps)."""
    cold_s = rep.init_seconds + rep.warmup(batch, prompt_len)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, rep.cfg.vocab_size, (batch, prompt_len), dtype=np.int64)
    g = rep.generate(tokens, new_tokens)
    return cold_s, g.prefill_s + g.decode_s


def plan_and_replay(cold_s: float, warm_s: float, rate: float, horizon: float,
                    cold_slo: float, device=None):
    """Plan the threshold on the simulator, then replay a Poisson workload
    with exponential service times of those means through the platform.
    Returns ``(plan, observed PlatformMetrics)``."""
    from repro_torch.core.execution import Execution
    from repro_torch.data.workload import poisson_arrivals
    from repro_torch.serving.autoscale import plan_expiration_threshold
    from repro_torch.serving.platform import ServerlessPlatform

    # the f32 block engine's sweep: faas_sweep on the card, its plain version
    # on the CPU
    block = Execution(backend="ref" if str(device) == "cpu" else "cuda")
    plan = plan_expiration_threshold(rate, warm_s, cold_s, cold_slo, sim_time=horizon,
                                     device=device, execution=block)
    rng = np.random.default_rng(0)
    platform = ServerlessPlatform(
        cold_time_fn=lambda r: float(rng.exponential(cold_s)),
        warm_time_fn=lambda r: float(rng.exponential(warm_s)),
        expiration_threshold=plan.expiration_threshold,
    )
    obs = platform.run(poisson_arrivals(rate, horizon), horizon)
    return plan, obs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--rate", type=float, default=0.2, help="req/s")
    ap.add_argument("--horizon", type=float, default=20000.0)
    ap.add_argument("--cold-slo", type=float, default=0.05)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1, help="sequences per request")
    ap.add_argument("--width", choices=("full", "smoke"), default="full",
                    help="the arch's published widths or its smoke config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serving.engine import Replica

    cfg = (get_config if args.width == "full" else get_smoke_config)(args.arch)
    if torch.device(args.device or "cuda").type == "cuda":
        # the kernel libraries, built apart from a replica's cold start
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        _build.build_all(("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
                          "faas_event_step"))
        print(f"[serve] CUDA kernels ready in {time.perf_counter() - t0:.1f}s")
    print(f"[serve] measuring {cfg.name} on {args.device or 'cuda'}...")
    rep = Replica(cfg, max_len=args.prompt_len + args.new_tokens + 8, device=args.device)
    cold_s, warm_s = measure(rep, args.batch, args.prompt_len, args.new_tokens)
    print(f"[serve] cold {cold_s:.2f}s, warm {warm_s:.3f}s")
    del rep

    plan, obs = plan_and_replay(cold_s, warm_s, args.rate, args.horizon, args.cold_slo,
                                device=args.device)
    print(
        f"[serve] threshold {plan.expiration_threshold:.0f}s → predicted "
        f"cold {plan.predicted_cold_prob:.3%}, replicas "
        f"{plan.predicted_avg_replicas:.2f}, wasted {plan.predicted_wasted_ratio:.1%}"
    )
    print(
        f"[serve] observed cold {obs.cold_start_prob:.3%}, replicas "
        f"{obs.avg_total_replicas:.2f}, wasted {obs.wasted_ratio:.1%}, "
        f"resp {obs.avg_response_time:.3f}s over {len(obs.records)} requests"
    )
    return plan, obs


if __name__ == "__main__":
    main()
