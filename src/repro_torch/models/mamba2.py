"""Mamba-2 SSD (state-space duality) block, the port of
``repro.models.mamba2``.

The chunked SSD (arXiv:2405.21060 §6): within a chunk of Q positions an
attention-like term over ``(B, nc, Q, Q, nh)``, per-chunk summary states, a
recurrence over the ``nc`` chunks, and the inter-chunk term.  Plain PyTorch,
as the reference is plain ``jnp``: no TPU kernel stands behind it.  The
block's linears (``wz``, ``wx``, ``wbc``, ``wdt``, ``out_proj``) go through
:func:`~repro_torch.models.common.apply_linear`, so a quantized one runs
the dequantizing GEMM.

Decode is the O(1) recurrence ``S ← exp(dt·A)·S + dt·(B ⊗ x)``,
``y = C·S + D·x``, with a rolling ``ssm_conv − 1``-deep convolution state.
The state is a dict of three leaves (the reference's ``MambaCache``):
``conv_x (B, k−1, nh, hd)`` and ``conv_bc (B, k−1, 2GN)`` in the model's
dtype, ``ssm (B, nh, hd, N)`` fp32.  :func:`mamba_apply` and
:func:`mamba_decode` return a new state; the model writes it into its cache.

On a rank of a "model" axis (``shard``, the model's ``_SSMShard``) the
block runs the heads ``shard.heads`` gives, ``h0 .. h0 + nh − 1``: its
``wz``/``wx``/``wdt`` outputs, convolution weights, norm scale, state and
``out_proj`` rows are those heads' (the whole ``a_log``, ``dt_bias`` and
``d_skip`` are sliced here), each head reads the B/C group of its global
index (:func:`_local_groups`), and the projections, the gated norm's sum
of squares and ``out_proj`` go through ``shard``, which holds the
collectives.  Under autograd the replicated tensors that feed the rank's
heads alone (the block's input to its own projections, the B/C
activations after their convolution, the whole ``a_log``, ``dt_bias`` and
``d_skip``) pass through ``shard.enter`` / ``shard.heads_of``, so their
gradients, and those of the replicated leaves behind them (``wbc``,
``conv_bc_*``), sum every rank's heads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import apply_linear, rmsnorm

__all__ = ["mamba_apply", "mamba_decode"]


def _local_groups(b: torch.Tensor, c: torch.Tensor, h0: int, nh: int, nh_all: int):
    """B and C (groups on dim −2) for heads ``h0 .. h0 + nh − 1`` of
    ``nh_all``, head h reading group ``h // (nh_all / G)``: the groups those
    heads span where each holds the same number of them (whole groups, or a
    part of one), else one group a head."""
    G = b.shape[-2]
    if nh == nh_all or G == 1:
        return b, c
    hpg = nh_all // G
    g0, g1 = h0 // hpg, (h0 + nh - 1) // hpg
    if g0 == g1 or (h0 % hpg == 0 and nh % hpg == 0):
        return b[..., g0 : g1 + 1, :], c[..., g0 : g1 + 1, :]
    idx = torch.arange(h0, h0 + nh, device=b.device) // hpg
    return b.index_select(-2, idx), c.index_select(-2, idx)


def _dw_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution along axis 1.  x: (B, L, *ch), w:
    (*ch, K).  The K products are summed in x's dtype, in order, as the
    reference's Python ``sum``."""
    k, L = w.shape[-1], x.shape[1]
    xp = torch.cat([x.new_zeros(x.shape[0], k - 1, *x.shape[2:]), x], 1)
    out = xp[:, 0:L] * w[..., 0]
    for i in range(1, k):
        out = out + xp[:, i : i + L] * w[..., i]
    return out + b


def _ssd_chunked(
    x: torch.Tensor,  # (B, L, nh, hd)
    dt: torch.Tensor,  # (B, L, nh) fp32, post-softplus
    a: torch.Tensor,  # (nh,) negative
    b: torch.Tensor,  # (B, L, G, N)
    c: torch.Tensor,  # (B, L, G, N)
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # (B, nh, hd, N) initial state
):
    """Returns ``(y (B, L, nh, hd) fp32, final state (B, nh, hd, N) fp32)``.
    Products run in fp32 over the exact upcasts of their operands (the
    reference's ``preferred_element_type=float32``); heads ``g·hpg ..
    (g+1)·hpg − 1`` read B/C group g, for G = 1 and G > 1 alike."""
    B, L, nh, hd = x.shape
    G, N = b.shape[2], b.shape[3]
    hpg = nh // G
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x, dt, b, c = (torch.cat([t, t.new_zeros(B, pad, *t.shape[2:])], 1) for t in (x, dt, b, c))
    nc = (L + pad) // Q

    xc = x.reshape(B, nc, Q, nh, hd).to(torch.float32)
    dtc = dt.reshape(B, nc, Q, nh).to(torch.float32)
    bc = b.reshape(B, nc, Q, G, N).to(torch.float32)
    cc = c.reshape(B, nc, Q, G, N).to(torch.float32)

    da = dtc * a.to(torch.float32)[None, None, None, :]  # (B, nc, Q, nh) <= 0
    da_cs = torch.cumsum(da, 2)  # inclusive
    da_tot = da_cs[:, :, -1]  # (B, nc, nh)

    # Intra-chunk (quadratic in Q, attention-like).
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
    seg = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # (B, nc, Q, Q, nh): i, j
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # The mask goes inside the exp: exp(seg) overflows for i < j, and a mask
    # applied after it puts 0·inf = NaN into the backward pass.
    decay = torch.exp(seg.masked_fill(~causal, -torch.inf))
    del seg
    scores = (
        cb.reshape(B, nc, G, 1, Q, Q).expand(B, nc, G, hpg, Q, Q).reshape(B, nc, nh, Q, Q)
        .permute(0, 1, 3, 4, 2)
        * decay
        * dtc[:, :, None, :, :]  # dt_j on the source index
    )  # (B, nc, Q, Q, nh)
    del decay
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", scores, xc)
    del scores

    # Chunk summary states S_c = Σ_j exp(da_tot − da_cs[j]) dt_j B_j ⊗ x_j.
    w_state = torch.exp(da_tot[:, :, None, :] - da_cs) * dtc  # (B, nc, Q, nh)
    xw = xc.reshape(B, nc, Q, G, hpg, hd) * w_state.reshape(B, nc, Q, G, hpg)[..., None]
    bx = torch.einsum("bcqgn,bcqghd->bcghdn", bc, xw).reshape(B, nc, nh, hd, N)

    # Inter-chunk recurrence over the nc chunks: the state before each chunk.
    h = torch.zeros(B, nh, hd, N, dtype=torch.float32, device=x.device) if h0 is None \
        else h0.to(torch.float32)
    h_before = []
    for ci in range(nc):
        h_before.append(h)
        h = h * torch.exp(da_tot[:, ci])[:, :, None, None] + bx[:, ci]
    h_before = torch.stack(h_before, 1)  # (B, nc, nh, hd, N)

    # Inter-chunk contribution: y_i += exp(da_cs[i]) C_i · H_before.
    cfac = torch.exp(da_cs).reshape(B, nc, Q, G, hpg)
    y_inter = (torch.einsum("bcqgn,bcghdn->bcqghd", cc, h_before.reshape(B, nc, G, hpg, hd, N))
               * cfac[..., None]).reshape(B, nc, Q, nh, hd)

    y = (y_intra + y_inter).reshape(B, nc * Q, nh, hd)
    return y[:, :L], h


def _mine(shard, t: torch.Tensor) -> torch.Tensor:
    """A tensor every rank holds whole, about to be cut to the rank's heads."""
    return t if shard is None else shard.heads_of(t)


def _dt_a(p: dict, dt_raw: torch.Tensor, h0: int, nh: int, shard=None):
    dt_bias, a_log = _mine(shard, p["dt_bias"]), _mine(shard, p["a_log"])
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias[h0 : h0 + nh].to(torch.float32))
    return dt, -torch.exp(a_log[h0 : h0 + nh].to(torch.float32))


def _heads(cfg, shard) -> tuple:
    return (0, cfg.ssm_nheads) if shard is None else shard.heads


def _projections(p: dict, x: torch.Tensor, nh: int, hd: int, shard):
    """``z``, ``x`` before the convolution, B/C before theirs and dt before
    the softplus: ``wz``/``wx``/``wdt`` on the heads the rank runs, ``wbc``
    whole on every rank."""
    if shard is None:
        proj = lambda w, shape, name: apply_linear(w, x, out_shape=shape, name=name)
        dt_in = x
    else:
        xf = shard.enter(x)
        proj = lambda w, shape, name: shard.project(w, x, xf, shape, name)
        dt_in = xf if shard.split else x
    return (proj(p["wz"], (nh, hd), "wz"), proj(p["wx"], (nh, hd), "wx"),
            apply_linear(p["wbc"], x, name="wbc"), apply_linear(p["wdt"], dt_in, name="wdt"))


def _gate_out(p: dict, y: torch.Tensor, xin: torch.Tensor, z: torch.Tensor, dtype, shard,
              h0: int) -> torch.Tensor:
    """D skip, SiLU(z) gate, RMSNorm over (nh·hd), out_proj."""
    skip = _mine(shard, p["d_skip"])[h0 : h0 + y.shape[-2]].to(torch.float32)
    y = y + xin.to(torch.float32) * skip.reshape(*([1] * (y.dim() - 2)), -1, 1)
    y = (y.to(dtype) * F.silu(z)).reshape(*y.shape[:-2], -1)
    if shard is None:
        return apply_linear(p["out_proj"], rmsnorm(y, p["norm_scale"].reshape(-1)),
                            name="out_proj")
    return shard.out_proj(p["out_proj"], shard.rmsnorm(y, p["norm_scale"].reshape(-1)))


def mamba_apply(p: dict, x: torch.Tensor, cfg, *, chunk: int = 128, return_cache: bool = False,
                shard=None):
    """Full-sequence SSD block (train, prefill).  x: (B, L, D), the block's
    normed input.  Returns ``(out (B, L, D), state or None)``; the state
    starts from zero, as the reference's prefill does."""
    B, L, _ = x.shape
    h0, nh = _heads(cfg, shard)
    hd = cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state

    # z the gate, xin_pre before the conv, bc_pre (B, L, 2GN), dt_raw (B, L, nh)
    z, xin_pre, bc_pre, dt_raw = _projections(p, x, nh, hd, shard)

    xin = F.silu(_dw_conv(xin_pre, p["conv_x_w"], p["conv_x_b"]))
    bcv = _mine(shard, F.silu(_dw_conv(bc_pre, p["conv_bc_w"], p["conv_bc_b"])))
    b, c = _local_groups(*bcv.reshape(B, L, 2 * G, N).split(G, dim=2), h0, nh, cfg.ssm_nheads)
    dt, a = _dt_a(p, dt_raw, h0, nh, shard)

    y, h_final = _ssd_chunked(xin, dt, a, b, c, chunk=chunk)
    out = _gate_out(p, y, xin, z, x.dtype, shard, h0)
    if not return_cache:
        return out, None
    k = cfg.ssm_conv
    return out, {"conv_x": _last_k(xin_pre, k - 1), "conv_bc": _last_k(bc_pre, k - 1),
                 "ssm": h_final}


def _last_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k`` positions of x along axis 1, zero-padded on the left
    when the sequence is shorter (the causal convolution's own padding)."""
    if x.shape[1] < k:
        x = torch.cat([x.new_zeros(x.shape[0], k - x.shape[1], *x.shape[2:]), x], 1)
    return x[:, x.shape[1] - k :]


def mamba_decode(p: dict, x: torch.Tensor, cfg, cache: dict, *, shard=None):
    """One recurrent step.  x: (B, 1, D); ``cache`` the block's state.
    Returns ``(out (B, 1, D), new state)``.  The convolution over the rolling
    buffer is one contraction (fp32 sum, rounded once to the buffer's
    dtype), as the reference's einsum; prefill's :func:`_dw_conv` rounds
    after each product instead."""
    B = x.shape[0]
    h0, nh = _heads(cfg, shard)
    hd = cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    xt = x[:, 0]

    z, xin_new, bc_new, dt_raw = _projections(p, xt, nh, hd, shard)

    conv_x_hist = torch.cat([cache["conv_x"], xin_new[:, None]], 1)  # (B, k, nh, hd)
    conv_bc_hist = torch.cat([cache["conv_bc"], bc_new[:, None]], 1)  # (B, k, 2GN)
    xin = F.silu(_contract_time(conv_x_hist, p["conv_x_w"]) + p["conv_x_b"])
    bc = F.silu(_contract_time(conv_bc_hist, p["conv_bc_w"]) + p["conv_bc_b"])
    b, c = _local_groups(*bc.reshape(B, 2 * G, N).split(G, dim=1), h0, nh, cfg.ssm_nheads)

    dt, a = _dt_a(p, dt_raw, h0, nh, shard)
    da = torch.exp(dt * a[None, :])  # (B, nh)
    xin32 = xin.to(torch.float32)
    bh = b.repeat_interleave(nh // b.shape[1], dim=1).to(torch.float32)  # (B, nh, N)
    ch = c.repeat_interleave(nh // c.shape[1], dim=1).to(torch.float32)
    ssm = cache["ssm"] * da[:, :, None, None] + (
        dt[:, :, None, None] * xin32[:, :, :, None] * bh[:, :, None, :])
    y = torch.einsum("bhdn,bhn->bhd", ssm, ch)
    out = _gate_out(p, y, xin, z, x.dtype, shard, h0)[:, None]
    return out, {"conv_x": conv_x_hist[:, 1:], "conv_bc": conv_bc_hist[:, 1:], "ssm": ssm}


def _contract_time(hist: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bt...,...t->b...")`` in fp32, rounded once to the operands'
    common dtype."""
    dtype = torch.promote_types(hist.dtype, w.dtype)
    wt = w.to(torch.float32).movedim(-1, 0)  # (k, *ch)
    return (hist.to(torch.float32) * wt[None]).sum(1).to(dtype)
