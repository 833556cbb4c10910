"""Scans: the plain PyTorch versions of the two scan kernels.

:func:`ssd_chunked_ref` is the port of ``repro/models/ssm.py::
ssd_chunked_ref``, the chunked exact Mamba-2 SSD (arXiv:2405.21060 §6)
that ``kernels/csrc/ssd_scan.cu`` computes: the sequence is split into
chunks of ``chunk`` tokens; within a chunk the output is an attention-like
quadratic form masked by cumulative decay; across chunks a state
``[B, H, P, N]`` is carried.  :func:`rglru_scan_ref` is the linear
recurrence of the RG-LRU (``repro/models/rglru.py::rglru_scan_ref``) that
``kernels/csrc/rglru_scan.cu`` computes.  The model blocks
(:mod:`repro_torch.models.ssm`, :mod:`repro_torch.models.rglru`) call them
through :mod:`repro_torch.kernels.ops`, which picks the kernel or the plain
version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked_ref(
    x: torch.Tensor,  # [B, L, H, P] inputs (already conv'd / gated)
    dt: torch.Tensor,  # [B, L, H] softplus'd step sizes
    A: torch.Tensor,  # [H] negative decay rates
    Bm: torch.Tensor,  # [B, L, G, N]
    Cm: torch.Tensor,  # [B, L, G, N]
    chunk: int = 256,
    initial_state=None,  # [B, H, P, N]
):
    """Returns (y [B, L, H, P], final_state [B, H, P, N])."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L_orig = L
    if L % chunk:  # pad the tail with dt = 0 tokens (decay 1, zero input: no-ops)
        pad = chunk - L % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        L = L + pad
    nc = L // chunk
    hpg = H // G

    # fold dt into x and decay: dA = dt * A (negative), dBx = dt * x
    dA = dt * A[None, None, :]  # [B, L, H]
    xd = x * dt[..., None]  # [B, L, H, P]

    xc = xd.reshape(Bsz, nc, chunk, H, P)
    dAc = dA.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N)

    # cumulative decay within chunk: cum[t] = sum_{u<=t} dA[u]
    cum = torch.cumsum(dAc, dim=2)  # [B, nc, Q, H]

    # intra-chunk (diagonal blocks): attention-like with decay mask
    # decay[t, s] = exp(cum[t] - cum[s]) for s <= t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, Q, Q, H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    del seg
    # scores[t, s] = C_t . B_s (per group, repeated over the group's heads)
    scores = torch.einsum("bzqgn,bzsgn->bzqsg", Cc, Bc)  # [B, nc, Q, Q, G]
    scores = scores.repeat_interleave(hpg, dim=-1)  # [B, nc, Q, Q, H]
    y_diag = torch.einsum("bzqsh,bzshp->bzqhp", scores * decay, xc)
    del scores, decay

    # chunk states: state_z = sum_s exp(cum[last] - cum[s]) B_s x_s
    last = cum[:, :, -1:, :]  # [B, nc, 1, H]
    state_decay = torch.exp(last - cum)  # [B, nc, Q, H]
    Bh = Bc.repeat_interleave(hpg, dim=3)  # [B, nc, Q, H, N]
    Ch = Cc.repeat_interleave(hpg, dim=3)
    chunk_states = torch.einsum("bzshn,bzsh,bzshp->bzhpn", Bh, state_decay, xc)

    # inter-chunk scan: carry the state across chunks
    chunk_total_decay = torch.exp(dAc.sum(dim=2))  # [B, nc, H]
    st = (torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
          if initial_state is None else initial_state)
    entering = []
    for z in range(nc):
        entering.append(st)  # the state entering chunk z
        st = st * chunk_total_decay[:, z, :, None, None] + chunk_states[:, z]
    entering = torch.stack(entering, dim=1)  # [B, nc, H, P, N]

    # inter-chunk contribution: y_t += C_t . (decay_to_t * state_in)
    in_decay = torch.exp(cum)  # [B, nc, Q, H]
    y_off = torch.einsum("bzqhn,bzqh,bzhpn->bzqhp", Ch, in_decay, entering)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y[:, :L_orig], st


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t, one step after another,
    as the TPU kernel computes it (the reference's plain version runs it as
    an associative scan, which rounds in another order).

    a, b: [B, L, W] (f32). Returns (h [B, L, W], h_last [B, W])."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    out = torch.empty_like(b)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, out[:, -1]
