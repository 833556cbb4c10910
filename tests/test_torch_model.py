"""The port's model stack against the JAX reference at the llama3.2-1b smoke
config in f32, with the reference's weights carried across by
``interop.params_from_reference``.

Tolerance: 2e-4 absolute and relative on logits and caches, the tolerance
to which the JAX package's own two backends (jnp ref and Pallas interpret)
agree (``tests/test_kernel_backend.py``).  Decode logits are compared
teacher-forced (both sides fed the same tokens), not as free-running
streams, so that an argmax tie cannot make correct runs diverge; the greedy
streams are compared once, on the CPU, where both sides compute in f32.
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
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Replica as JReplica
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_reference
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Replica

TOL = 2e-4
S, MAX_LEN, B, STEPS = 64, 72, 2, 3


def _cfgs():
    j = dataclasses.replace(jget_smoke("llama3.2-1b"), compute_dtype="float32")
    p = dataclasses.replace(get_smoke_config("llama3.2-1b"), compute_dtype="float32")
    return j, p


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = _cfgs()
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.key(0))
    pm = build_model(pcfg, device="cpu",
                     params=params_from_reference(jax.device_get(jparams), pcfg))
    return jm, jparams, pm


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _flat_caches(jcaches):
    """The reference's stacked per-segment caches as one (k, v) per layer."""
    out = []
    for seg in jcaches:
        (entry,) = seg  # one "attn" element per repetition
        k, v = np.asarray(entry["k"]), np.asarray(entry["v"])
        out.extend(zip(k, v))
    return out


def test_configs_are_the_reference_configs():
    for get_p, get_j in ((get_config, jget_config), (get_smoke_config, jget_smoke)):
        p, j = get_p("llama3.2-1b"), get_j("llama3.2-1b")
        assert dataclasses.asdict(p) == dataclasses.asdict(j)


@pytest.mark.parametrize("backend", ["ref", "pallas_interpret"])
def test_prefill_and_decode_match_jax(models, backend):
    jm, jparams, pm = models
    cfg = pm.cfg
    tokens = _tokens(1, (B, S), cfg.vocab_size)
    feed = _tokens(2, (B, STEPS), cfg.vocab_size)
    with jops.kernel_backend(backend):
        jl, jc, jlen = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, MAX_LEN)
        jc_prefill = _flat_caches(jc)
        jsteps = []
        for i in range(STEPS):
            lg, jc, jlen = jm.decode_step(jparams, jnp.asarray(feed[:, i:i + 1]), jc, jlen)
            jsteps.append(np.asarray(lg))
    with torch.inference_mode():
        pl, pc, plen = pm.prefill({"tokens": torch.from_numpy(tokens).long()}, MAX_LEN)
        # the decode steps write into the caches in place: keep the prefill's
        pc_prefill = [(e["k"].clone(), e["v"].clone()) for e in pc]
        psteps = []
        for i in range(STEPS):
            lg, pc, plen = pm.decode_step(torch.from_numpy(feed[:, i:i + 1]).long(), pc, plen)
            psteps.append(lg.numpy())
    assert pl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for i in range(STEPS):
        np.testing.assert_allclose(psteps[i], jsteps[i], atol=TOL, rtol=TOL)
    assert np.array_equal(plen.numpy(), np.asarray(jlen))
    for (pk, pv), (jk, jv) in zip(pc_prefill, jc_prefill):
        assert not pk[:, S:].any()  # padded to max_len with zeros
        np.testing.assert_allclose(pk.numpy(), jk, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(pv.numpy(), jv, atol=TOL, rtol=TOL)
    # after the steps: the fed tokens' keys and values at slots S .. S+2
    for e, (jk, jv) in zip(pc, _flat_caches(jc)):
        np.testing.assert_allclose(e["k"].numpy(), jk, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(e["v"].numpy(), jv, atol=TOL, rtol=TOL)


# the dense-attention options the served config leaves off
VARIANTS = [
    dict(qk_norm=True, partial_rotary=0.5, attn_logit_softcap=30.0),
    dict(logit_softcap=20.0, embedding_scale=True, activation="gelu", tie_embeddings=False),
    dict(ffn_type="mlp", activation="gelu", n_kv_heads=1),
]


@pytest.mark.parametrize("variant", VARIANTS)
def test_config_variants_match_jax(variant):
    jcfg, pcfg = (dataclasses.replace(c, **variant) for c in _cfgs())
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.key(1))
    pm = build_model(pcfg, device="cpu",
                     params=params_from_reference(jax.device_get(jparams), pcfg))
    tokens = _tokens(8, (B, 32), pcfg.vocab_size)
    feed = _tokens(9, (B, 2), pcfg.vocab_size)
    jl, jc, jlen = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 40)
    with torch.inference_mode():
        pl, pc, plen = pm.prefill({"tokens": torch.from_numpy(tokens).long()}, 40)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        for i in range(2):
            jl, jc, jlen = jm.decode_step(jparams, jnp.asarray(feed[:, i:i + 1]), jc, jlen)
            pl, pc, plen = pm.decode_step(torch.from_numpy(feed[:, i:i + 1]).long(), pc, plen)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_full_cache_overwrites_its_last_slot(models):
    """A cache at T = max_len keeps writing slot T - 1, as the reference."""
    jm, jparams, pm = models
    tokens = _tokens(3, (B, 8), pm.cfg.vocab_size)
    feed = _tokens(4, (B, 2), pm.cfg.vocab_size)
    jl, jc, jlen = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 8)
    with torch.inference_mode():
        pl, pc, plen = pm.prefill({"tokens": torch.from_numpy(tokens).long()}, 8)
        for i in range(2):
            jl, jc, jlen = jm.decode_step(jparams, jnp.asarray(feed[:, i:i + 1]), jc, jlen)
            pl, pc, plen = pm.decode_step(torch.from_numpy(feed[:, i:i + 1]).long(), pc, plen)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_replica_generate_matches_jax_tokens():
    jcfg, pcfg = _cfgs()
    jrep = JReplica(jcfg, max_len=48, seed=5)
    rep = Replica(pcfg, max_len=48, device="cpu",
                  params=params_from_reference(jax.device_get(jrep.params), pcfg))
    tokens = _tokens(6, (2, 24), pcfg.vocab_size)
    jg = jrep.generate(tokens, new_tokens=12)
    pg = rep.generate(tokens, new_tokens=12)
    assert pg.tokens.shape == (2, 12)
    np.testing.assert_array_equal(pg.tokens, np.asarray(jg.tokens))
    assert pg.prefill_s > 0 and pg.decode_s > 0
    assert rep.init_seconds > 0 and rep.warmup(1, 8) > 0


def test_port_init_is_seeded_and_finite():
    _, cfg = _cfgs()
    tokens = torch.from_numpy(_tokens(7, (1, 16), cfg.vocab_size)).long()
    with torch.inference_mode():
        a = build_model(cfg, seed=3, device="cpu").prefill({"tokens": tokens}, 20)[0]
        b = build_model(cfg, seed=3, device="cpu").prefill({"tokens": tokens}, 20)[0]
        c = build_model(cfg, seed=4, device="cpu").prefill({"tokens": tokens}, 20)[0]
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)


def test_unported_archs_and_kinds_raise():
    with pytest.raises(NotImplementedError, match="Queue A item 9b"):
        get_config("gemma-2b")
    with pytest.raises(NotImplementedError, match="Queue A item 9b"):
        get_smoke_config("deepseek-v3-671b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("bogus")
    _, cfg = _cfgs()
    mla = dataclasses.replace(cfg, segments=((("attn", "mla"), 1),))
    with pytest.raises(NotImplementedError, match="mla"):
        build_model(mla, device="cpu")
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
