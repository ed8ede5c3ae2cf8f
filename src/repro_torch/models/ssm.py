"""Mamba-2 layer (SSD, state-space duality, arXiv:2405.21060): the port of
the reference's ``models/ssm.py``.

``ssd_forward`` is the chunked SSD of prefill (quadratic within a chunk, a
linear recurrence across chunks: the reference's ``lax.scan`` becomes a
Python loop), with per-row ``lengths`` for right-padded buckets;
``ssd_decode_step`` is the one-token recurrence, updating the cache's
``conv`` and ``state`` tensors in place so a captured CUDA graph replays
it. Plain torch on the tensors' own device: the reference has no Pallas
kernel here. Nothing reads the host (no ``.item()``, no ``nonzero``), so
the decode step can be captured.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import SSMConfig
from repro_torch.models.mlp import bf16_matmul


class MambaCache(NamedTuple):
    """Per-row recurrent state of one Mamba layer (leading axes as given:
    (B,) for one layer, (nsb, B) for a stack)."""
    conv: torch.Tensor    # (..., d_conv, conv_dim) bf16: last conv inputs
    state: torch.Tensor   # (..., H, P, N) float32 SSM state


def conv_dim(cfg: SSMConfig, d_model: int) -> int:
    return cfg.d_inner(d_model) + 2 * cfg.n_groups * cfg.d_state


def in_proj_dim(cfg: SSMConfig, d_model: int) -> int:
    return 2 * cfg.d_inner(d_model) + 2 * cfg.n_groups * cfg.d_state + \
        cfg.n_heads(d_model)


def init_mamba(normal, d_model: int, cfg: SSMConfig, lead: tuple,
               device) -> Dict:
    """The reference's leaves and scales: ``in_proj`` / ``out_proj`` normal
    · fan_in^-1/2 in bf16, ``conv_w`` · d_conv^-1/2, ``A_log`` =
    log(linspace(1, 16, H)), ``dt_bias`` zeros, ``D`` ones (all float32),
    the gate norm's scale ones. ``normal(shape, scale)``: the caller's
    seeded draw of ``lead + shape``."""
    di, nh = cfg.d_inner(d_model), cfg.n_heads(d_model)

    def const(v, dtype):
        return v.to(dtype).to(device).expand(lead + v.shape).clone()

    return {
        "in_proj": normal((d_model, in_proj_dim(cfg, d_model)),
                          d_model ** -0.5),
        "conv_w": normal((cfg.d_conv, conv_dim(cfg, d_model)),
                         cfg.d_conv ** -0.5),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh)),
                       torch.float32),
        "dt_bias": const(torch.zeros(nh), torch.float32),
        "D": const(torch.ones(nh), torch.float32),
        "gate_norm": {"scale": const(torch.ones(di), torch.bfloat16)},
        "out_proj": normal((di, d_model), di ** -0.5),
    }


def init_mamba_cache(lead: tuple, d_model: int, cfg: SSMConfig,
                     device) -> MambaCache:
    """Zeroed rows: conv (*lead, d_conv, conv_dim) bf16, state (*lead, H,
    P, N) float32."""
    return MambaCache(
        conv=torch.zeros(tuple(lead) + (cfg.d_conv, conv_dim(cfg, d_model)),
                         dtype=torch.bfloat16, device=device),
        state=torch.zeros(tuple(lead) + (cfg.n_heads(d_model), cfg.head_dim,
                                         cfg.d_state),
                          dtype=torch.float32, device=device))


def _gated_rmsnorm(p: Dict, y: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)).to(y.dtype) * p["scale"]


def _split_proj(zxbcdt: torch.Tensor, d_model: int, cfg: SSMConfig):
    di = cfg.d_inner(d_model)
    gn = cfg.n_groups * cfg.d_state
    nh = cfg.n_heads(d_model)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * gn]
    dt = zxbcdt[..., 2 * di + 2 * gn:2 * di + 2 * gn + nh]
    return z, xBC, dt


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) → (..., L, L) with out[i, j] = sum_{j<t<=i} a_t (−inf
    above the diagonal)."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _heads(xBC: torch.Tensor, di: int, cfg: SSMConfig, nh: int):
    """xBC (..., conv_dim) → x (..., H, P), B and C (..., H, N) (groups
    repeated over their heads)."""
    P, N, G = cfg.head_dim, cfg.d_state, cfg.n_groups
    lead = xBC.shape[:-1]
    xh = xBC[..., :di].reshape(lead + (nh, P))
    Bm = xBC[..., di:di + G * N].reshape(lead + (G, N))
    Cm = xBC[..., di + G * N:].reshape(lead + (G, N))
    hpg = nh // G
    return (xh, torch.repeat_interleave(Bm, hpg, dim=-2),
            torch.repeat_interleave(Cm, hpg, dim=-2))


def ssd_forward(params: Dict, cfg: SSMConfig, d_model: int, x: torch.Tensor,
                init_state: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None):
    """Full-sequence SSD. x (B, S, d_model) → (y (B, S, d_model), the final
    ``MambaCache``): ``in_proj``, ``ssd_scan``, ``out_proj``.

    ``lengths`` ((B,) integers) marks each row's true length in a
    right-padded bucket: positions at or past it get ``dt = 0``, so they
    neither advance nor decay the state (the returned state is the state
    after the last real token), and the conv window is gathered around
    each row's own last real input; a ``lengths == 0`` row keeps a zero
    conv window. Outputs at padded positions are garbage."""
    y, cache = ssd_scan(params, cfg, d_model,
                        bf16_matmul(x, params["in_proj"]), init_state,
                        lengths)
    return bf16_matmul(y, params["out_proj"]), cache


def ssd_scan(params: Dict, cfg: SSMConfig, d_model: int,
             zxbcdt: torch.Tensor, init_state: Optional[torch.Tensor] = None,
             lengths: Optional[torch.Tensor] = None):
    """``ssd_forward`` between its two projections: the in-projection's
    output zxbcdt (B, S, in_proj_dim) → (the gated-norm output y (B, S,
    d_inner) in zxbcdt's dtype, the final ``MambaCache``): the conv, the
    chunked scan, ``D`` and the gated norm, which read no projection
    weight (what a rank of a tensor-parallel group runs whole)."""
    B, S, _ = zxbcdt.shape
    di, nh = cfg.d_inner(d_model), cfg.n_heads(d_model)
    P, N = cfg.head_dim, cfg.d_state
    Q = cfg.chunk
    if S % Q:
        raise ValueError(f"seq {S} not divisible by SSD chunk {Q}")
    dev = zxbcdt.device
    dtype = zxbcdt.dtype
    z, xBC, dt_raw = _split_proj(zxbcdt, d_model, cfg)

    # Causal depthwise conv over the sequence; its cache is the last K raw
    # inputs (the window ending at each row's last real token).
    K = params["conv_w"].shape[0]
    xBC_pad = torch.cat([xBC.new_zeros((B, K - 1, xBC.shape[-1])), xBC],
                        dim=1)
    if lengths is None:
        conv_tail = xBC_pad[:, S - 1:S + K - 1]
    else:
        lengths = lengths.to(torch.int64)
        tidx = torch.clamp(lengths[:, None] - 1, 0, S - 1) + \
            torch.arange(K, device=dev)[None, :]                   # (B, K)
        conv_tail = torch.gather(
            xBC_pad, 1, tidx[..., None].expand(-1, -1, xBC.shape[-1]))
        conv_tail = conv_tail * (lengths > 0)[:, None, None].to(
            conv_tail.dtype)
    windows = torch.stack([xBC_pad[:, i:i + S] for i in range(K)], dim=2)
    # The reference's einsum over the K taps: a bf16 dot, float32 sums.
    xBC = torch.einsum("bskc,kc->bsc", windows.float(),
                       params["conv_w"].float()).to(xBC.dtype)
    xBC = F.silu(xBC.float()).to(dtype)

    xh, Bm, Cm = _heads(xBC, di, cfg, nh)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])            # (B,S,H)
    if lengths is not None:
        pos_valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        dt = torch.where(pos_valid[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(params["A_log"])                                # (H,)
    dA = dt * A

    nc = S // Q
    xh_c = xh.float().reshape(B, nc, Q, nh, P)
    B_c = Bm.float().reshape(B, nc, Q, nh, N)
    C_c = Cm.float().reshape(B, nc, Q, nh, N)
    dt_c = dt.reshape(B, nc, Q, nh)
    dA_c = dA.reshape(B, nc, Q, nh)

    Acum = torch.cumsum(dA_c, dim=2)                               # (B,c,Q,H)
    Lmat = torch.exp(_segsum(dA_c.permute(0, 1, 3, 2)))            # (B,c,H,Q,Q)
    xdt = xh_c * dt_c[..., None]
    y_diag = torch.einsum("bclhn,bcshn,bchls,bcshp->bclhp",
                          C_c, B_c, Lmat, xdt)
    decay_states = torch.exp(Acum[:, :, -1:, :] - Acum)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn",
                          B_c, decay_states * dt_c, xh_c)         # (B,c,H,P,N)
    chunk_decay = torch.exp(Acum[:, :, -1, :])                     # (B,c,H)

    carry = init_state if init_state is not None else \
        torch.zeros((B, nh, P, N), dtype=torch.float32, device=dev)
    prev = []
    for c in range(nc):
        prev.append(carry)               # the state before chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                         # (B,c,H,P,N)

    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", C_c, prev_states,
                         torch.exp(Acum))
    y = (y_diag + y_off).reshape(B, S, nh, P)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(dtype)
    y = _gated_rmsnorm(params["gate_norm"], y, z)
    return y, MambaCache(conv=conv_tail.to(torch.bfloat16), state=carry)


def ssd_decode_step(params: Dict, cfg: SSMConfig, d_model: int,
                    x: torch.Tensor, cache: MambaCache,
                    row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token recurrence. x (B, 1, d_model) → y (B, 1, d_model):
    ``in_proj``, ``ssd_decode_scan``, ``out_proj``; the cache's ``conv``
    and ``state`` are updated in place. ``row_valid`` (B,) bool: rows
    outside it keep their state (vacant rows, and rows of another decode
    group of the same step: the reference's ``guard_ssm`` merge)."""
    y = ssd_decode_scan(params, cfg, d_model,
                        bf16_matmul(x[:, 0], params["in_proj"]), cache,
                        row_valid)
    return bf16_matmul(y, params["out_proj"])[:, None, :]


def ssd_decode_scan(params: Dict, cfg: SSMConfig, d_model: int,
                    zxbcdt: torch.Tensor, cache: MambaCache,
                    row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ssd_decode_step`` between its two projections: zxbcdt (B,
    in_proj_dim) → the gated-norm output y (B, d_inner); updates the
    cache in place where ``row_valid`` holds."""
    B = zxbcdt.shape[0]
    di, nh = cfg.d_inner(d_model), cfg.n_heads(d_model)
    z, xBC, dt_raw = _split_proj(zxbcdt, d_model, cfg)
    conv = torch.cat([cache.conv[:, 1:], xBC[:, None, :].to(cache.conv.dtype)],
                     dim=1)
    xBC = torch.einsum("bkc,kc->bc", conv.float(),
                       params["conv_w"].float()).to(conv.dtype)
    xBC = F.silu(xBC.float())

    xh, Bm, Cm = _heads(xBC, di, cfg, nh)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])            # (B, H)
    dA = torch.exp(dt * -torch.exp(params["A_log"]))
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt, Bm, xh)
    state = cache.state * dA[..., None, None] + dBx
    y = torch.einsum("bhn,bhpn->bhp", Cm, state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, di).to(zxbcdt.dtype)
    y = _gated_rmsnorm(params["gate_norm"], y, z)
    if row_valid is not None:
        keep = row_valid.reshape(B)
        conv = torch.where(keep[:, None, None], conv, cache.conv)
        state = torch.where(keep[:, None, None, None], state, cache.state)
    cache.conv.copy_(conv)
    cache.state.copy_(state)
    return y
