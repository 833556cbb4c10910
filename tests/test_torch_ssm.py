"""The port's Mamba-2 path against the JAX reference on the CPU: the plain
SSD scan (``models/scans.py::ssd_chunked_ref``, the plain version of
``kernels/csrc/ssd_scan.cu``), the block's prefill and decode, and the
``mamba2-2.7b`` smoke model, with the reference's weights carried across by
``interop.params_from_reference`` and inputs made with numpy.

Tolerances: the scan within 2e-4 absolute, as ``tests/test_kernels.py``
holds the Pallas kernel to the sequential oracle (the frameworks sum the
chunk products in other orders); blocks and the smoke model in f32 within
2e-4 absolute and relative, as ``tests/test_torch_model.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Replica as JReplica
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.launch import serve
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import scans, ssm
from repro_torch.models.model import build_model, build_params, cast_params
from repro_torch.models.param import ParamBuilder
from repro_torch.serving.engine import Replica

ARCH = "mamba2-2.7b"
SCAN_TOL = 2e-4
TOL = 2e-4


def _scan_inputs(seed, B, L, H, P, N, G):
    """test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, L, H)))) * 0.3).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_scan_matches_jax_chunked(chunk, G):
    arrays = _scan_inputs(0, 2, 256, 4, 64, 128, G)
    y, st = scans.ssd_chunked_ref(*_t(*arrays), chunk=chunk)
    jy, jst = jssm.ssd_chunked_ref(*_j(*arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=SCAN_TOL)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_scan_matches_pallas_interpret_and_sequential(chunk, G):
    """test_kernels.py's shapes: the Pallas kernel takes x*dt, dt*A and B, C
    broadcast to heads; the sequential oracle ``kernels/ref.py::ssd_scan_ref``
    the same."""
    x, dt, A, Bm, Cm = _scan_inputs(1, 2, 256, 4, 64, 128, G)
    y, st = scans.ssd_chunked_ref(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    hpg = 4 // G
    xd = jnp.asarray(x * dt[..., None])
    dA = jnp.asarray(dt * A[None, None, :])
    Bh = jnp.repeat(jnp.asarray(Bm), hpg, axis=2)
    Ch = jnp.repeat(jnp.asarray(Cm), hpg, axis=2)
    py, pst = ssd_scan_pallas(xd, dA, Bh, Ch, chunk=chunk, interpret=True)
    sy, sst = jref.ssd_scan_ref(xd, dA, Bh, Ch)
    for ry, rst in ((py, pst), (sy, sst)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=SCAN_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(rst), atol=SCAN_TOL)


@pytest.mark.parametrize("L,chunk", [(200, 64), (77, 256), (5, 16)])
def test_plain_scan_ragged_length_and_initial_state(L, chunk):
    """A length that is no multiple of the chunk is padded with dt = 0 rows
    in both frameworks; an initial state is carried into the first chunk."""
    arrays = _scan_inputs(2, 2, L, 4, 32, 16, 2)
    h0 = np.random.default_rng(3).standard_normal((2, 4, 32, 16)).astype(np.float32)
    y, st = scans.ssd_chunked_ref(*_t(*arrays), chunk=chunk, initial_state=torch.from_numpy(h0))
    jy, jst = jssm.ssd_chunked_ref(*_j(*arrays), chunk=chunk, initial_state=jnp.asarray(h0))
    assert y.shape == (2, L, 4, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=SCAN_TOL)


def test_plain_scan_is_chunk_independent():
    """The kernel scans in its own 64-token chunks while the model asks for
    256: in exact arithmetic the chunk does not matter, so the plain version
    at 64 and at 256 differ by rounding only."""
    arrays = _t(*_scan_inputs(4, 1, 512, 4, 64, 128, 1))
    y64, s64 = scans.ssd_chunked_ref(*arrays, chunk=64)
    y256, s256 = scans.ssd_chunked_ref(*arrays, chunk=256)
    np.testing.assert_allclose(y64.numpy(), y256.numpy(), atol=SCAN_TOL)
    np.testing.assert_allclose(s64.numpy(), s256.numpy(), atol=SCAN_TOL)


def test_decode_step_matches_jax_and_continues_the_scan():
    """Each decode step equals the reference's on the same state and inputs,
    and stepping token by token from a prefix's final state gives the
    scan's outputs of the longer sequence."""
    x, dt, A, Bm, Cm = _t(*_scan_inputs(5, 2, 40, 4, 32, 16, 2))
    y, _ = scans.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=16)
    _, st = scans.ssd_chunked_ref(x[:, :36], dt[:, :36], A, Bm[:, :36], Cm[:, :36], chunk=16)
    for t in range(36, 40):
        step_in = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        jyt, jst = jssm.ssd_decode_step(*_j(st.numpy(), *(a.numpy() for a in step_in)))
        yt, st = ssm.ssd_decode_step(st, *step_in)
        np.testing.assert_allclose(yt.numpy(), np.asarray(jyt), atol=SCAN_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=SCAN_TOL)
        np.testing.assert_allclose(yt.numpy(), y[:, t].numpy(), atol=SCAN_TOL)


def test_scan_dispatch_on_the_cpu():
    """On CPU tensors the wrapper and the dispatch layer run the plain
    version; kernel_backend("cuda") refuses them; shapes are checked."""
    x, dt, A, Bm, Cm = _t(*_scan_inputs(6, 1, 64, 4, 32, 16, 1))
    before = LAUNCH_COUNTS["ssd_scan"]
    ref = scans.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=32)
    for out in (ssd_scan(x, dt, A, Bm, Cm, chunk=32), ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)):
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert LAUNCH_COUNTS["ssd_scan"] == before
    with ops.kernel_backend("cuda"), pytest.raises(ValueError, match="needs CUDA"):
        ops.ssd_scan(x, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="dt must be"):
        ssd_scan(x, dt[:, :10], A, Bm, Cm)
    with pytest.raises(ValueError, match="multiple of G"):
        ssd_scan(x, dt, A, Bm.expand(1, 64, 3, 16), Cm.expand(1, 64, 3, 16))


# ---------------------------------------------------------------------------
# blocks and the smoke model
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
    """The reference's stacked per-segment caches as one dict per layer."""
    out = []
    for seg in jcaches:
        count = len(next(iter(seg[0].values())))
        for r in range(count):
            out.extend({k: np.asarray(v[r]) for k, v in e.items()} for e in seg)
    return out


def test_configs_are_the_reference_configs():
    for get_p, get_j in ((get_config, jget_config), (get_smoke_config, jget_smoke)):
        assert dataclasses.asdict(get_p(ARCH)) == dataclasses.asdict(get_j(ARCH))


def test_block_prefill_and_decode_match_jax(models):
    """mamba2_block's output, final state and conv tail, then two
    mamba2_decode steps, against the reference's on its own weights."""
    _, jparams, pm, pparams = models
    cfg, jcfg = pm.cfg, _cfgs()[0]
    jmix = jax.tree.map(lambda a: a[0], jparams["blocks"][0][0]["mixer"])
    pmix = pparams["blocks"][0]["mixer"]
    x = np.random.default_rng(7).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    jy, (jst, jtail) = jssm.mamba2_block(jmix, jnp.asarray(x), jcfg)
    y, (st, tail) = ssm.mamba2_block(pmix, torch.from_numpy(x), cfg)
    for a, b in ((y, jy), (st, jst), (tail, jtail)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    for t in range(2):
        xt = np.random.default_rng(8 + t).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst, jtail = jssm.mamba2_decode(jmix, jnp.asarray(xt), jcfg, jst, jtail)
        y, st, tail = ssm.mamba2_decode(pmix, torch.from_numpy(xt), cfg, st, tail)
        for a, b in ((y, jy), (st, jst), (tail, jtail)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


S, MAX_LEN, B, STEPS = 48, 56, 2, 3


def test_smoke_model_matches_jax(models):
    """Prefill logits, the decode caches (f32 state, conv window) and
    teacher-forced decode logits of the 2-layer smoke model."""
    jm, jparams, pm, _ = models
    tokens, feed = _tokens(1, (B, S)), _tokens(2, (B, STEPS))
    jl, jc, jlen = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, MAX_LEN)
    with torch.inference_mode():
        pl, pc, plen = pm.prefill({"tokens": torch.from_numpy(tokens).long()}, MAX_LEN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert np.array_equal(plen.numpy(), np.asarray(jlen))
    for e, je in zip(pc, _flat_caches(jc)):
        assert set(e) == {"state", "conv"} and e["state"].dtype == torch.float32
        for k in e:
            np.testing.assert_allclose(e[k].numpy(), je[k], atol=TOL, rtol=TOL)
    for i in range(STEPS):
        jl, jc, jlen = jm.decode_step(jparams, jnp.asarray(feed[:, i:i + 1]), jc, jlen)
        with torch.inference_mode():
            pl, pc, plen = pm.decode_step(torch.from_numpy(feed[:, i:i + 1]).long(), pc, plen)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for e, je in zip(pc, _flat_caches(jc)):
        for k in e:
            np.testing.assert_allclose(e[k].numpy(), je[k], atol=TOL, rtol=TOL)


def test_empty_cache_matches_jax_layout(models):
    jm, _, pm, _ = models
    jc = _flat_caches(jax.device_get(jm.init_cache(2, MAX_LEN)))
    pc = pm.init_cache(2, MAX_LEN)
    assert len(pc) == len(jc) == pm.cfg.n_layers
    for e, je in zip(pc, jc):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in e.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in je.items()}
        assert not any(v.any() for v in e.values())


def test_replica_generate_matches_jax_tokens():
    jcfg, pcfg = _cfgs()
    jrep = JReplica(jcfg, max_len=40, seed=5)
    rep = Replica(pcfg, max_len=40, device="cpu",
                  params=params_from_reference(jax.device_get(jrep.params), pcfg))
    tokens = _tokens(6, (2, 20))
    jg, pg = jrep.generate(tokens, new_tokens=10), rep.generate(tokens, new_tokens=10)
    np.testing.assert_array_equal(pg.tokens, np.asarray(jg.tokens))


def test_bf16_keeps_the_f32_leaves():
    """In bf16 the leaves the reference reads in f32 (A_log, D, dt_bias)
    stay f32, on random init and through interop, with the reference's
    exact values; so the step sizes and decays the block computes equal the
    reference's, where rounding those leaves to bf16 would move them."""
    jcfg, pcfg = _cfgs("bfloat16")
    jparams = jax.device_get(jbuild_model(jcfg).init(jax.random.key(3)))
    pparams = params_from_reference(jparams, pcfg)
    ssm_leaves = {"A_log", "D", "dt_bias"}
    for tree in (pparams, build_model(pcfg, seed=1, device="cpu").params):
        mix = tree["blocks"][1]["mixer"]
        for name in ssm_leaves:
            assert mix[name].dtype == torch.float32, name
        assert mix["in_proj"].dtype == torch.bfloat16
    f32 = {k for k, v in pparams["blocks"][1]["mixer"].items()
           if isinstance(v, torch.Tensor) and v.dtype == torch.float32}
    assert f32 == ssm_leaves
    jmix = jax.tree.map(lambda a: a[1], jparams["blocks"][0][0]["mixer"])
    pmix = pparams["blocks"][1]["mixer"]
    for name in ssm_leaves:
        np.testing.assert_array_equal(pmix[name].numpy(), np.asarray(jmix[name]))
    raw = np.random.default_rng(9).standard_normal((2, 8, 4)).astype(np.float32)
    dt, A = ssm._ssm_inputs(pmix, torch.from_numpy(raw).bfloat16())
    jdt = jax.nn.softplus(jnp.asarray(raw).astype(jnp.bfloat16).astype(jnp.float32)
                          + jmix["dt_bias"].astype(jnp.float32))
    jA = -jnp.exp(jmix["A_log"].astype(jnp.float32))
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-6)  # exp: one ulp apart
    rounded = {k: v.bfloat16() if k in ssm_leaves else v for k, v in pmix.items()}
    _, A_bf = ssm._ssm_inputs(rounded, torch.from_numpy(raw).bfloat16())
    assert (A_bf - A).abs().max() > 1e-3


def test_carried_tree_takes_the_builders_dtypes_and_shapes():
    """``cast_params`` casts each leaf of a tree made elsewhere to the dtype
    the builder gives it, and refuses a tree whose leaves, shapes or layer
    count differ from what the config builds."""
    _, pcfg = _cfgs("bfloat16")
    tree = build_params(ParamBuilder(torch.Generator().manual_seed(0), torch.float32), pcfg)
    out = cast_params(tree, pcfg, "cpu")
    mix = out["blocks"][1]["mixer"]
    assert mix["A_log"].dtype == torch.float32 and mix["in_proj"].dtype == torch.bfloat16
    assert torch.equal(mix["A_log"], tree["blocks"][1]["mixer"]["A_log"])
    assert out["embed"]["table"].dtype == torch.bfloat16
    dropped = dict(tree["blocks"][1]["mixer"])
    del dropped["D"]
    with pytest.raises(ValueError, match="hold"):
        cast_params(dict(tree, blocks=[tree["blocks"][0], {**tree["blocks"][1], "mixer": dropped},
                                       *tree["blocks"][2:]]), pcfg, "cpu")
    with pytest.raises(ValueError, match="builds"):
        cast_params(dict(tree, final_norm={"scale": torch.ones(3)}), pcfg, "cpu")
    with pytest.raises(ValueError, match="layers"):
        cast_params(dict(tree, blocks=tree["blocks"][:-1]), pcfg, "cpu")


def test_serve_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch mamba2-2.7b --width smoke
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
