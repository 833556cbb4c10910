"""The CUDA kernel against its plain PyTorch version on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a visible GPU.
This file imports no JAX, so on a machine without JAX it runs alone:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.kernels import faas_event_step as fes  # noqa: E402
from repro_torch.kernels.ref import faas_sweep_ref  # noqa: E402

# per-row sequential sums of identically computed values: equal bit for bit
EXACT_COLS = [0, 1, 2, 5, 6, 7]
# columns 3-4: the kernel sums each event's run/idle time over the M slots
# in a warp-tree order, torch in its own; the last-place differences
# accumulate over K = 300 f32 additions
INTEGRAL_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda", 0)


def _inputs(dev, seed, R, M, K, t_exp, prestamped, rate=0.6):
    rng = np.random.default_rng(seed)
    dts = rng.exponential(1 / rate, (R, K))
    horizon = K / rate
    if prestamped:
        dts = np.cumsum(dts, axis=1)
        dts[:, -K // 8:] = 1e30
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    args = (
        torch.zeros((R, M), dtype=torch.float32, device=dev),
        torch.full((R, M), -1e30, dtype=torch.float32, device=dev),
        torch.full((R, M), -1e30, dtype=torch.float32, device=dev),
        torch.zeros((R,), dtype=torch.float32, device=dev),
        t(t_exp * rng.uniform(0.5, 1.5, R)),
        t(dts),
        t(rng.exponential(2.0, (R, K))),
        t(rng.exponential(2.5, (R, K))),
    )
    kw = dict(t_end=t(horizon * rng.uniform(0.5, 0.9, R)),
              skip=t(horizon * rng.uniform(0.0, 0.1, R)))
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize(
    "M,t_exp,max_c,prestamped",
    [
        (40, 10.0, 100, False),
        (40, 3.0, 4, False),  # rejections
        (7, 50.0, 100, False),  # one slot per lane, slots past M masked
        (130, 30.0, 1000, True),  # five slots per lane, absolute timestamps
    ],
)
def test_kernel_matches_plain(cuda_device, M, t_exp, max_c, prestamped):
    args, kw = _inputs(cuda_device, 5, 37, M, 300, t_exp, prestamped)
    kw.update(max_concurrency=max_c, prestamped=prestamped)
    before = fes.LAUNCH_COUNTS["faas_sweep"]
    out_k = [o.cpu().numpy() for o in fes.faas_sweep(*args, **kw)]
    assert fes.LAUNCH_COUNTS["faas_sweep"] == before + 1
    out_p = [o.cpu().numpy() for o in faas_sweep_ref(*args, **kw)]
    for a, b in zip(out_k[:4], out_p[:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out_k[4][:, EXACT_COLS], out_p[4][:, EXACT_COLS])
    np.testing.assert_allclose(out_k[4][:, 3:5], out_p[4][:, 3:5], rtol=INTEGRAL_RTOL)


@pytest.mark.cuda
def test_wrapper_checks_inputs(cuda_device):
    args, kw = _inputs(cuda_device, 6, 8, 8, 64, 10.0, False)
    state, t_exp, (dts, warms, colds) = args[:4], args[4], args[5:]
    with pytest.raises(ValueError, match="contiguous"):
        fes.faas_sweep(*state, t_exp, dts.t().contiguous().t(), warms, colds,
                       max_concurrency=4)
    with pytest.raises(ValueError, match="float32"):
        fes.faas_sweep(*state, t_exp, dts.double(), warms, colds, max_concurrency=4)
    with pytest.raises(ValueError, match="shape"):
        fes.faas_sweep(*state, t_exp, dts[:, :10].contiguous(), warms, colds,
                       max_concurrency=4)
