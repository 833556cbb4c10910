"""The port's Griffin path against the JAX reference on the CPU: the plain
RG-LRU scan (``models/scans.py::rglru_scan_ref``, the plain version of
``kernels/csrc/rglru_scan.cu``), the recurrent block's prefill and decode,
the local-attention ring cache and the ``recurrentgemma-9b`` smoke model,
with the reference's weights carried across by
``interop.params_from_reference`` and inputs made with numpy.

Tolerances: the scan within 2e-5 absolute, as ``tests/test_kernels.py``
holds the Pallas kernel to the associative scan (the port steps through
the recurrence in order, as the Pallas kernel does; the reference's plain
version composes it as an associative scan, which rounds in another
order); blocks and the smoke model in f32 within 2e-4 absolute and
relative, as ``tests/test_torch_model.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro.models import rglru as jrglru
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Replica as JReplica
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.launch import serve
from repro_torch.kernels.rglru_scan import launch_plan, rglru_scan
from repro_torch.models import rglru, scans
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Replica

ARCH = "recurrentgemma-9b"
SCAN_TOL = 2e-5
TOL = 2e-4


def _scan_inputs(seed, B, L, W):
    """test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, L, W))))).astype(np.float32)
    b = (rng.standard_normal((B, L, W)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((B, W)) * 0.1).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk,block_w", [(64, 256), (128, 512)])
def test_plain_scan_matches_jax_and_pallas_interpret(with_h0, chunk, block_w):
    a, b, h0 = _scan_inputs(0, 2, 256, 512)
    th0, jh0 = (torch.from_numpy(h0), jnp.asarray(h0)) if with_h0 else (None, None)
    y, h_last = scans.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b), th0)
    for jy, jlast in (
        jrglru.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0),
        rglru_scan_pallas(jnp.asarray(a), jnp.asarray(b), jh0, chunk=chunk,
                          block_w=block_w, interpret=True),
    ):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SCAN_TOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(jlast), atol=SCAN_TOL)


@pytest.mark.parametrize("L,W", [(1, 64), (77, 96), (300, 4096)])
def test_plain_scan_any_length_and_width(L, W):
    """Lengths and widths the Pallas launcher's tiling would refuse."""
    a, b, h0 = _scan_inputs(1, 2, L, W)
    y, h_last = scans.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(h0))
    jy, jlast = jrglru.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SCAN_TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jlast), atol=SCAN_TOL)


def test_decode_step_continues_the_scan():
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 2, 20, 64))
    y, _ = scans.rglru_scan_ref(a, b, h0)
    _, h = scans.rglru_scan_ref(a[:, :15], b[:, :15], h0)
    for t in range(15, 20):
        out, h = rglru.rglru_step(a[:, t], b[:, t], h)
        jout, _ = jrglru.rglru_step(*(jnp.asarray(x[:, t].numpy()) for x in (a, b)),
                                    jnp.asarray(y[:, t - 1].numpy()))
        assert torch.equal(out, y[:, t])
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=SCAN_TOL)


def test_scan_dispatch_on_the_cpu():
    """On CPU tensors the wrapper and the dispatch layer run the plain
    version; kernel_backend("cuda") refuses them; shapes are checked."""
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(3, 2, 33, 64))
    before = LAUNCH_COUNTS["rglru_scan"]
    ref = scans.rglru_scan_ref(a, b, h0)
    for out in (rglru_scan(a, b, h0), ops.rglru_scan(a, b, h0)):
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert LAUNCH_COUNTS["rglru_scan"] == before
    with ops.kernel_backend("cuda"), pytest.raises(ValueError, match="needs CUDA"):
        ops.rglru_scan(a, b)
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan(a, b[:, :5])
    with pytest.raises(ValueError, match="h0 must be"):
        rglru_scan(a, b, h0[:, :5])


@pytest.mark.parametrize("B,W,a_off,b_off,path,grid", [
    (4, 4096, 0, 0, "tma", (128, 4)),  # recurrentgemma-9b's prefill
    (1, 4096, 0, 0, "tma", (128, 1)),
    (2, 200, 0, 0, "tma", (7, 2)),  # a row of 800 bytes, a ragged last warp
    (2, 101, 0, 0, "cp.async", (4, 2)),  # a row of 404 bytes
    (3, 4096, 4, 0, "cp.async", (128, 3)),  # a view one element into its buffer
    (3, 4096, 0, 36, "cp.async", (128, 3)),
    (3, 4096, 48, 16, "tma", (128, 3)),
])
def test_launch_plan_picks_the_load_path_and_grid(B, W, a_off, b_off, path, grid):
    """TMA for 16-byte aligned bases and a row stride of whole 16 bytes,
    4-byte cp.async for anything else; a block per 32 channels of a row."""
    base = 1 << 30
    assert launch_plan(B, W, torch.float32, base + a_off, base + b_off) == (path, grid)


# ---------------------------------------------------------------------------
# blocks, the ring cache and the smoke model
# ---------------------------------------------------------------------------


def _cfgs(dtype="float32"):
    j = dataclasses.replace(jget_smoke(ARCH), compute_dtype=dtype)
    p = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=dtype)
    return j, p


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = _cfgs()
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.key(0))
    pparams = params_from_reference(jax.device_get(jparams), pcfg)
    return jm, jparams, build_model(pcfg, device="cpu", params=pparams), pparams


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _flat_caches(jcaches):
    """The reference's stacked per-segment caches as one dict per layer, in
    the order the stack runs the layers."""
    out = []
    for seg in jcaches:
        count = len(next(iter(seg[0].values())))
        for r in range(count):
            out.extend({k: np.asarray(v[r]) for k, v in e.items()} for e in seg)
    return out


def test_configs_are_the_reference_configs():
    for get_p, get_j in ((get_config, jget_config), (get_smoke_config, jget_smoke)):
        assert dataclasses.asdict(get_p(ARCH)) == dataclasses.asdict(get_j(ARCH))


def test_recurrent_block_prefill_and_decode_match_jax(models):
    _, jparams, pm, pparams = models
    cfg, jcfg = pm.cfg, _cfgs()[0]
    jmix = jax.tree.map(lambda a: a[0], jparams["blocks"][0][1]["mixer"])
    pmix = pparams["blocks"][1]["mixer"]
    x = np.random.default_rng(7).standard_normal((2, 29, cfg.d_model)).astype(np.float32)
    jy, (jh, jtail) = jrglru.recurrent_block(jmix, jnp.asarray(x), jcfg)
    y, (h, tail) = rglru.recurrent_block(pmix, torch.from_numpy(x), cfg)
    for a, b in ((y, jy), (h, jh), (tail, jtail)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    for t in range(2):
        xt = np.random.default_rng(8 + t).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, (jh, jtail) = jrglru.recurrent_block_decode(jmix, jnp.asarray(xt), jcfg, jh, jtail)
        y, (h, tail) = rglru.recurrent_block_decode(pmix, torch.from_numpy(xt), cfg, h, tail)
        for a, b in ((y, jy), (h, jh), (tail, jtail)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def _run_both(jm, jparams, pm, S, max_len, steps, backend="ref", seed=1):
    """Prefill S tokens and decode ``steps`` fed tokens on both sides; returns
    [(port logits, reference logits)] and the final (port, reference) caches,
    and the caches right after the prefill."""
    tokens, feed = _tokens(seed, (2, S)), _tokens(seed + 1, (2, steps))
    pairs = []
    with jops.kernel_backend(backend), torch.inference_mode():
        jl, jc, jlen = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, max_len)
        pl, pc, plen = pm.prefill({"tokens": torch.from_numpy(tokens).long()}, max_len)
        prefill_caches = ([{k: v.clone() for k, v in e.items()} for e in pc],
                          _flat_caches(jc))
        pairs.append((pl, jl))
        for i in range(steps):
            jl, jc, jlen = jm.decode_step(jparams, jnp.asarray(feed[:, i:i + 1]), jc, jlen)
            pl, pc, plen = pm.decode_step(torch.from_numpy(feed[:, i:i + 1]).long(), pc, plen)
            pairs.append((pl, jl))
    assert np.array_equal(plen.numpy(), np.asarray(jlen))
    return pairs, (pc, _flat_caches(jc)), prefill_caches


def _caches_close(pc, jc):
    assert len(pc) == len(jc)
    for e, je in zip(pc, jc):
        assert set(e) == set(je)
        for k in e:
            np.testing.assert_allclose(e[k].numpy(), je[k], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("backend", ["ref", "pallas_interpret"])
def test_smoke_model_matches_jax(models, backend):
    """Prefill logits, every layer's decode cache (h f32, conv windows, ring
    k/v) and teacher-forced decode logits; the 40-token prompt is longer
    than the 16-token window, so the local layer's ring wraps."""
    jm, jparams, pm, _ = models
    pairs, (pc, jc), (pc0, jc0) = _run_both(jm, jparams, pm, 40, 48, 3, backend)
    for pl, jl in pairs:
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _caches_close(pc0, jc0)
    _caches_close(pc, jc)
    kinds = [set(e) for e in pc]
    assert kinds == [{"h", "conv"}, {"h", "conv"}, {"k", "v"}, {"h", "conv"}]
    assert pc[0]["h"].dtype == torch.float32


@pytest.mark.parametrize("S,max_len,steps", [
    (10, 64, 9),  # a prompt shorter than the window, the ring filling and wrapping
    (16, 64, 3),  # a prompt of exactly the window
    (37, 64, 17),  # the prefill rolled by S % w, then more than a window of steps
    (12, 12, 6),  # max_len below the window: a ring of max_len slots
])
def test_local_ring_cache_wraps_as_the_reference(models, S, max_len, steps):
    jm, jparams, pm, _ = models
    pairs, (pc, jc), (pc0, jc0) = _run_both(jm, jparams, pm, S, max_len, steps, seed=S)
    for pl, jl in pairs:
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _caches_close(pc0, jc0)
    _caches_close(pc, jc)
    assert pc[2]["k"].shape[1] == min(max_len, pm.cfg.window)


def test_replica_generate_matches_jax_tokens():
    jcfg, pcfg = _cfgs()
    jrep = JReplica(jcfg, max_len=48, seed=5)
    rep = Replica(pcfg, max_len=48, device="cpu",
                  params=params_from_reference(jax.device_get(jrep.params), pcfg))
    tokens = _tokens(6, (2, 24))
    jg, pg = jrep.generate(tokens, new_tokens=12), rep.generate(tokens, new_tokens=12)
    np.testing.assert_array_equal(pg.tokens, np.asarray(jg.tokens))


def test_bf16_keeps_the_f32_leaves():
    """In bf16 the RG-LRU gate weights and biases and lambda_p stay f32, on
    random init and through interop, with the reference's exact values, so
    the gates (a, gated input) equal the reference's; rounding those leaves
    to bf16 would move them."""
    jcfg, pcfg = _cfgs("bfloat16")
    jparams = jax.device_get(jbuild_model(jcfg).init(jax.random.key(3)))
    pparams = params_from_reference(jparams, pcfg)
    lru_leaves = {"w_a", "w_x", "b_a", "b_x", "lambda_p"}
    for tree in (pparams, build_model(pcfg, seed=1, device="cpu").params):
        mix = tree["blocks"][0]["mixer"]
        for name in lru_leaves:
            assert mix["lru"][name].dtype == torch.float32, name
        assert mix["in_proj"].dtype == torch.bfloat16
    assert set(pparams["blocks"][0]["mixer"]["lru"]) == lru_leaves
    jlru = jax.tree.map(lambda a: a[0], jparams["blocks"][0][0]["mixer"]["lru"])
    plru = pparams["blocks"][0]["mixer"]["lru"]
    for name in lru_leaves:
        np.testing.assert_array_equal(plru[name].numpy(), np.asarray(jlru[name]))
    x = np.random.default_rng(9).standard_normal((2, 6, pcfg.rglru.lru_width))
    xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
    c = pcfg.rglru.c_constant
    a, gated = rglru._gates(plru, xb, c)
    ja, jgated = jrglru._gates(jlru, jnp.asarray(x, jnp.float32).astype(jnp.bfloat16), c)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gated.numpy(), np.asarray(jgated), rtol=1e-5, atol=1e-6)
    rounded = {k: v.bfloat16() for k, v in plru.items()}
    a_bf, _ = rglru._gates(rounded, xb, c)
    assert ((a_bf - a).abs() / a.abs()).max() > 1e-3  # 100x the tolerance above


def test_serve_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma-9b --width smoke
    --device cpu``: measured, planned and replayed."""
    plan, obs = serve.main(["--arch", ARCH, "--device", "cpu", "--width", "smoke",
                            "--horizon", "1500", "--rate", "0.3", "--prompt-len", "24",
                            "--new-tokens", "4", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"measuring {ARCH}-smoke on cpu" in out and "[serve] observed" in out
    assert len(obs.records) > 100 and 0 <= obs.cold_start_prob <= 1


def test_short_prompt_decodes_like_a_longer_prefill():
    """A 2-token prompt is shorter than the conv window (K - 1 = 3): its
    decode cache is left-padded with the conv's zeros, and decoding the
    rest of a prompt token by token ends where prefilling all of it does."""
    _, cfg = _cfgs()
    m = build_model(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(_tokens(11, (2, 6))).long()
    with torch.inference_mode():
        lg, caches, cache_len = m.prefill({"tokens": tokens[:, :2]}, 16)
        for i in range(2, 6):
            lg, caches, cache_len = m.decode_step(tokens[:, i:i + 1], caches, cache_len)
        full, _, _ = m.prefill({"tokens": tokens}, 16)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), atol=TOL, rtol=TOL)
