"""The port's plain attention (the kernels' plain versions) against the JAX
reference: ``repro.models.attention``'s jnp oracles and the Pallas kernels
in interpret mode, on the same numpy inputs.

Tolerance: f32 within 2e-5 absolute and relative (the f32 tolerance of
``tests/test_kernels.py``: the two frameworks sum the tiles' dot products
in different orders); bf16 within 2e-2 (one bf16 rounding of p and of the
output apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jatt
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention, n_splits
from repro_torch.kernels.faas_event_step import LAUNCH_COUNTS
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention, kernel_tiles
from repro_torch.models.attention import decode_attention_ref, flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return j, t


def _close(port, ref, dtype):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(ref, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype],
    )


FLASH_CASES = [
    # B, S, Hq, Hkv, D, options
    (2, 128, 4, 4, 64, dict(causal=True)),  # G = 1
    (1, 128, 8, 2, 64, dict(causal=True)),  # G = 4
    (1, 256, 4, 1, 32, dict(causal=True, window=48)),  # first tiles fully masked
    (2, 128, 4, 2, 64, dict(causal=True, prefix_len=48)),
    (1, 128, 4, 2, 64, dict(causal=False)),
    (1, 128, 2, 2, 128, dict(causal=True, softcap=30.0)),
    (1, 128, 8, 2, 64, dict(causal=True, window=40, softcap=20.0)),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,kw", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_ref_and_pallas(B, S, Hq, Hkv, D, kw, dtype):
    arrays = _arrays(S + D, [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)])
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    port = flash_attention_ref(tq, tk, tv, q_chunk=64, kv_chunk=64, **kw)
    assert port.dtype == TDT[dtype] and port.shape == (B, S, Hq, D)
    _close(port, jatt.flash_attention_ref(jq, jk, jv, q_chunk=64, kv_chunk=64, **kw), dtype)
    _close(port, flash_attention_pallas(jq, jk, jv, bq=64, bk=64, interpret=True, **kw), dtype)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=30),
                                dict(causal=False, softcap=10.0)])
def test_flash_ref_ragged_tiles(kw):
    """S = 100 in tiles of 32 (a short last tile) against the reference's
    single 100-wide tile: the tiling changes nothing but rounding."""
    arrays = _arrays(7, [(2, 100, 4, 64), (2, 100, 2, 64), (2, 100, 2, 64)])
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    port = flash_attention_ref(tq, tk, tv, q_chunk=32, kv_chunk=32, **kw)
    ref = jatt.flash_attention_ref(jq, jk, jv, q_chunk=100, kv_chunk=100, **kw)
    _close(port, ref, "float32")


# the bf16 kernel's tiles (192 x 128 at D <= 64, 128 x 128 to D = 128, 128 x
# 64 above): S = T = 384 is a multiple of each, as the JAX reference needs
KERNEL_TILE_CASES = [
    # B, Hq, Hkv, D, options
    (1, 4, 2, 64, dict(causal=True)),
    (1, 4, 1, 128, dict(causal=True, window=150)),
    (1, 16, 1, 256, dict(causal=True, window=200)),
    (1, 4, 2, 64, dict(causal=True, prefix_len=200)),
    (1, 2, 2, 96, dict(causal=False, softcap=20.0)),
]


@pytest.mark.parametrize("B,Hq,Hkv,D,kw", KERNEL_TILE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_at_the_kernel_tiles_matches_jax_ref(B, Hq, Hkv, D, kw, dtype):
    """The plain version tiled as the bf16 kernel tiles (the chunks at which
    the card's checks hold the kernel) against the JAX reference at the same
    chunks, on numpy inputs from a seed: within TOL."""
    S = 384
    q_chunk, kv_chunk = kernel_tiles(D, torch.bfloat16)
    assert S % q_chunk == 0 and S % kv_chunk == 0
    arrays = _arrays(D + S, [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)])
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    port = flash_attention_ref(tq, tk, tv, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
    ref = jatt.flash_attention_ref(jq, jk, jv, q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
    _close(port, ref, dtype)


def test_kernel_tiles_cover_every_head_dim():
    for D in HEAD_DIMS:
        bq, bk = kernel_tiles(D, torch.bfloat16)
        assert bq % 64 == 0 and bk % 64 == 0  # whole warpgroups, whole wgmma widths
    assert kernel_tiles(64, torch.float32) == (64, 64)


DECODE_CASES = [
    # B, T, Hq, Hkv, D, window, softcap, cache_len
    (3, 256, 4, 4, 64, 0, 0.0, [1, 100, 256]),  # G = 1
    (3, 256, 8, 2, 64, 0, 0.0, [1, 77, 256]),  # G = 4
    (2, 256, 8, 2, 64, 48, 0.0, [200, 256]),
    (2, 128, 4, 1, 128, 0, 30.0, [5, 128]),
]


@pytest.mark.parametrize("B,T,Hq,Hkv,D,window,softcap,lens", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_jax_ref_and_pallas(B, T, Hq, Hkv, D, window, softcap, lens, dtype):
    arrays = _arrays(T + D, [(B, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)])
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    kw = dict(window=window, softcap=softcap)
    port = decode_attention_ref(tq, tk, tv, torch.tensor(lens, dtype=torch.int32), **kw)
    assert port.dtype == TDT[dtype] and port.shape == (B, Hq, D)
    jl = jnp.asarray(lens, jnp.int32)
    _close(port, jatt.decode_attention_ref(jq, jk, jv, jl, **kw), dtype)
    _close(port, decode_attention_pallas(jq, jk, jv, jl, bk=64, interpret=True, **kw), dtype)


def test_wrappers_on_cpu_run_the_plain_versions():
    q, k, v = (torch.from_numpy(a) for a in _arrays(3, [(1, 64, 4, 32), (1, 64, 2, 32),
                                                         (1, 64, 2, 32)]))
    lens = torch.tensor([40], dtype=torch.int32)
    before = dict(LAUNCH_COUNTS)
    assert torch.equal(flash_attention(q, k, v, q_chunk=32, kv_chunk=32),
                       flash_attention_ref(q, k, v, q_chunk=32, kv_chunk=32))
    assert torch.equal(decode_attention(q[:, 0], k, v, lens),
                       decode_attention_ref(q[:, 0], k, v, lens))
    with ops.kernel_backend("ref"):
        assert torch.equal(ops.decode_attention(q[:, 0], k, v, lens),
                           decode_attention_ref(q[:, 0], k, v, lens))
    assert torch.equal(ops.flash_attention(q, k, v), flash_attention_ref(q, k, v))
    assert dict(LAUNCH_COUNTS) == before  # the plain versions launch nothing


def test_kernel_backend_cuda_on_cpu_tensors_raises():
    q, k, v = (torch.zeros(s) for s in [(1, 8, 2, 32), (1, 8, 1, 32), (1, 8, 1, 32)])
    lens = torch.tensor([8], dtype=torch.int32)
    with ops.kernel_backend("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.flash_attention(q, k, v)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.decode_attention(q[:, 0], k, v, lens)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        with ops.kernel_backend("pallas"):
            pass
    assert ops.current_backend() is None


def test_wrappers_check_shapes():
    q = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError, match="k and v must be"):
        flash_attention(q, torch.zeros((1, 8, 2, 64)), torch.zeros((1, 8, 2, 64)))
    with pytest.raises(ValueError, match="cache_len must be"):
        decode_attention(q[:, 0], torch.zeros((1, 8, 2, 32)), torch.zeros((1, 8, 2, 32)),
                         torch.tensor([1, 2], dtype=torch.int32))


def test_decode_splits_fill_the_card():
    # the serving path's decode: B = 4, Hkv = 8, T = 4096 -> 8 splits of 8 tiles
    assert n_splits(4, 8, 4096) == 8
    assert n_splits(4, 8, 4096, G=4) == 8  # llama's G fits one 16-row group
    # recurrentgemma's local layers: B = 4, Hkv = 1, G = 16, the 2,048-slot
    # ring -> one split per 64-key tile, 128 blocks
    assert n_splits(4, 1, 2048, G=16) == 32
    assert n_splits(4, 1, 2048, G=32) == 32  # two row groups: 256 blocks
    assert n_splits(1, 1, 64) == 1  # one tile cannot split
    assert n_splits(64, 8, 4096) == 1  # 512 blocks already
    for B, Hkv, T in [(3, 2, 1000), (1, 8, 130), (2, 1, 4096)]:
        s = n_splits(B, Hkv, T)
        tiles = -(-T // 64)
        tps = -(-tiles // s)
        assert 1 <= s <= tiles and (s - 1) * tps < tiles  # no split is past the end
