"""Mamba-2 (SSD, state-space duality) block, arXiv:2405.21060 (port of
``src/repro/models/mamba2.py``).

The sequence mixer of the SSM family (``mamba2-780m``). Prefill runs the
SSD scan through the kernel set it is given (the CUDA kernel on the card);
the gated RMSNorm goes through the RMSNorm kernel like every norm. Decode
stays plain torch ops, as the reference computes it in jnp outside any
kernel. ``ssd_chunked``, the reference's pure-jnp chunked scan, is the
training path's scan (the kernel has no backward).

B and C come in ``ssm_groups`` groups (``configs.pattern``; 1, as in the
reference, for every copied config): head h reads group h // (H / G), and
the gated RMSNorm then runs over each group's d_inner / G channels, as
Nemotron-H's ``MambaRMSNormGated(group_size=...)`` does. d_inner is
``cfg.d_inner`` (heads x head dim where the config sets ``ssm_n_heads``).

Quirk kept from the reference: prefill returns the conv tails in x's
dtype, while ``init_ssm_state`` makes them bfloat16.

Shapes: x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N), D (H,). State:
(B,H,P,N).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.pattern import option
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KERNELS, KernelSet
from repro_torch.models.layers import dense_init


@dataclasses.dataclass
class SSMState:
    """Decode-time state for one mamba layer."""

    conv_x: torch.Tensor  # (B, d_conv-1, d_inner): causal conv tail, x stream
    conv_bc: torch.Tensor  # (B, d_conv-1, 2*G*N): causal conv tail, B/C
    ssm: torch.Tensor  # (B, H, P, N) float32


class Mamba2(nn.Module):
    """Weights of one Mamba-2 mixer, with the leaf names of the reference's
    ``init_mamba``: the input projection split by stream (z / x / B,C / dt).
    """

    def __init__(self, cfg: ModelConfig, *, device,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        G = option(cfg, "ssm_groups")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.z_proj = dense_init(d, di, **kw)
        self.x_proj = dense_init(d, di, **kw)
        self.bc_proj = dense_init(d, 2 * G * n, **kw)
        self.dt_proj = dense_init(d, h, **kw)

        def conv_w(ch: int) -> nn.Parameter:
            w = torch.randn((cfg.ssm_conv, ch), device=device,
                            generator=generator) * (1.0 / cfg.ssm_conv)
            return nn.Parameter(w.to(dtype))

        def zeros(ch: int) -> nn.Parameter:
            return nn.Parameter(torch.zeros((ch,), device=device, dtype=dtype))

        self.conv_x_w = conv_w(di)
        self.conv_x_b = zeros(di)
        self.conv_bc_w = conv_w(2 * G * n)
        self.conv_bc_b = zeros(2 * G * n)
        f32 = dict(device=device, dtype=torch.float32)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, h + 1, **f32)))
        self.D = nn.Parameter(torch.ones((h,), **f32))
        # dt bias: inverse softplus of a log-uniform dt in [1e-3, 1e-1]
        u = torch.rand((h,), generator=generator, **f32)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt0 = torch.exp(u * (hi - lo) + lo)
        self.dt_bias = nn.Parameter(dt0 + torch.log(-torch.expm1(-dt0)))
        self.norm_scale = nn.Parameter(torch.ones((di,), **f32))
        self.out_proj = dense_init(di, d, **kw)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int, initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, differentiable (port of
    ``src/repro/models/mamba2.py:29``). Returns (y (B,S,H,P) in x's dtype,
    final state (B,H,P,N) float32); S must be a multiple of ``chunk``.

    Within a chunk the recurrence is the lower-triangular (L x L)
    "attention" of the duality; a loop over chunks carries the state and
    emits the state entering each chunk. All internal math in float32.
    One change from the reference: the masked upper triangle takes
    ``exp(-inf)`` where the reference takes ``where(tri, exp(seg), 0)``.
    The values are the same, but there ``exp(seg)`` overflows once a
    chunk's decay passes e^88 (mamba2-780m's chunk of 256 does) and its
    gradient is then 0 * inf = NaN; here it is 0.
    """
    Bsz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    nc, L = S // chunk, chunk
    hpg = H // G

    x_ = x.reshape(Bsz, nc, L, H, P).float()
    dt_ = dt.reshape(Bsz, nc, L, H).float()
    Br_ = B.reshape(Bsz, nc, L, G, N).float().repeat_interleave(hpg, dim=3)
    Cr_ = C.reshape(Bsz, nc, L, G, N).float().repeat_interleave(hpg, dim=3)

    a_cum = torch.cumsum(dt_ * A.float(), dim=2)  # (B,nc,L,H) log-decay

    # intra-chunk: decay(i,j) = exp(a_cum[i] - a_cum[j]) for i >= j
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B,nc,L,L,H)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bcihs,bcjhs->bcijh", Cr_, Br_)
    w = cb * decay * dt_[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, x_)

    # the state each chunk deposits, and each chunk's total decay
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)
    chunk_state = torch.einsum("bclhs,bclhp->bchps", Br_,
                               x_ * (dt_ * decay_to_end)[..., None])
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B,nc,H)

    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(entering, dim=1)  # (B,nc,H,P,N)

    y_inter = torch.einsum("bclhs,bchps->bclhp", Cr_, prev_states)
    y_inter = y_inter * torch.exp(a_cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def _gated_norm(kernels: KernelSet, y: torch.Tensor, z: torch.Tensor,
                p: Mamba2, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm of y * silu(z) over each B/C group's channels (all of
    d_inner for one group), through the kernel set's RMSNorm."""
    return kernels.rmsnorm(y * F.silu(z), p.norm_scale, eps=cfg.norm_eps,
                           group=cfg.d_inner // option(cfg, "ssm_groups"))


def _conv_with_tail(seq: torch.Tensor, tail: torch.Tensor | None,
                    w: torch.Tensor, b: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv as the reference's sum of K shifted products;
    returns (activated output, new K-1 tail)."""
    K = w.shape[0]
    ktail = K - 1
    if tail is None:
        ext = F.pad(seq, (0, 0, ktail, 0))
    else:
        ext = torch.cat([tail.to(seq.dtype), seq], dim=1)
    S = seq.shape[1]
    out = sum(ext[:, i:i + S, :] * w[i] for i in range(K))
    new_tail = ext[:, ext.shape[1] - ktail:] if ktail else seq[:, :0]
    return F.silu(out + b), new_tail


def mamba_forward(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                  initial_state: SSMState | None = None, *,
                  kernels: KernelSet = KERNELS
                  ) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence Mamba-2 mixer. x (B,S,d_model) -> (y, final SSMState)."""
    Bsz, S, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    G = option(cfg, "ssm_groups")
    z = x @ p.z_proj
    xs_raw = x @ p.x_proj
    bc_raw = x @ p.bc_proj
    dt = x @ p.dt_proj

    tail_x = initial_state.conv_x if initial_state is not None else None
    tail_bc = initial_state.conv_bc if initial_state is not None else None
    xs, new_tail_x = _conv_with_tail(xs_raw, tail_x, p.conv_x_w, p.conv_x_b)
    bc, new_tail_bc = _conv_with_tail(bc_raw, tail_bc, p.conv_bc_w,
                                      p.conv_bc_b)

    xs = xs.reshape(Bsz, S, h, hp)
    Bmat, Cmat = bc.chunk(2, dim=-1)
    Bmat = Bmat.reshape(Bsz, S, G, n)
    Cmat = Cmat.reshape(Bsz, S, G, n)
    dt_act = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    # pad seq to a chunk multiple; dt=0 on padding -> identity transitions,
    # zero deposits, so the final state is exact.
    chunk = min(cfg.ssm_chunk, max(S, 1))
    pad = (-S) % chunk
    if pad:
        def padseq(t: torch.Tensor) -> torch.Tensor:
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xs, dt_act = padseq(xs), padseq(dt_act)
        Bmat, Cmat = padseq(Bmat), padseq(Cmat)

    ssm0 = initial_state.ssm if initial_state is not None else None
    y, final = kernels.ssd_scan(xs, dt_act, A, Bmat, Cmat, p.D, chunk=chunk,
                                initial_state=ssm0)

    y = y[:, :S].reshape(Bsz, S, di)
    # gated RMSNorm (mamba2): normalize y * silu(z)
    y = _gated_norm(kernels, y, z, p, cfg)
    out = y @ p.out_proj
    return out, SSMState(conv_x=new_tail_x.to(x.dtype),
                         conv_bc=new_tail_bc.to(x.dtype), ssm=final)


def init_ssm_state(cfg: ModelConfig, batch: int, *,
                   device: str | torch.device = "cuda") -> SSMState:
    dev = resolve_device(device)
    G = option(cfg, "ssm_groups")
    tail = lambda ch: torch.zeros((batch, cfg.ssm_conv - 1, ch),
                                  dtype=torch.bfloat16, device=dev)
    return SSMState(
        conv_x=tail(cfg.d_inner),
        conv_bc=tail(2 * G * cfg.ssm_state),
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=dev))


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update. x (B,H,P), dt (B,H), B/C (B,G,N),
    state (B,H,P,N) -> (y (B,H,P), new_state)."""
    H = x.shape[1]
    hpg = H // B.shape[1]
    dA = torch.exp(dt.float() * A.float())  # (B,H)
    Br = B.float().repeat_interleave(hpg, dim=1)  # (B,H,N)
    Cr = C.float().repeat_interleave(hpg, dim=1)
    deposit = (dt.float()[..., None, None] * x.float()[..., None]
               * Br[:, :, None, :])
    new_state = state * dA[..., None, None] + deposit
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cr)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), new_state


def mamba_decode_step(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                      state: SSMState, kernels: KernelSet = KERNELS
                      ) -> tuple[torch.Tensor, SSMState]:
    """One-token mamba step. x (B,1,d_model). Plain torch ops, as the
    reference's decode; the gated norm goes through the kernel set's
    RMSNorm."""
    Bsz = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    G = option(cfg, "ssm_groups")
    xt = x[:, 0]  # (B, d)
    z = xt @ p.z_proj
    xs_raw = xt @ p.x_proj
    bc_raw = xt @ p.bc_proj
    dt = xt @ p.dt_proj

    def conv_step(tail, new, w, b):
        K = w.shape[0]
        window = torch.cat([tail.to(new.dtype), new[:, None, :]], dim=1)
        out = F.silu(torch.einsum("bkc,kc->bc", window, w) + b)
        new_tail = window[:, 1:] if K > 1 else window[:, :0]
        return out, new_tail

    xs, new_tail_x = conv_step(state.conv_x, xs_raw, p.conv_x_w, p.conv_x_b)
    bc, new_tail_bc = conv_step(state.conv_bc, bc_raw, p.conv_bc_w,
                                p.conv_bc_b)

    xs = xs.reshape(Bsz, h, hp)
    Bmat, Cmat = bc.chunk(2, dim=-1)
    Bmat = Bmat.reshape(Bsz, G, n)
    Cmat = Cmat.reshape(Bsz, G, n)
    dt_act = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, new_ssm = ssd_decode_step(xs, dt_act, A, Bmat, Cmat, p.D, state.ssm)
    y = y.reshape(Bsz, 1, di)
    y = _gated_norm(kernels, y, z[:, None, :], p, cfg)
    out = y @ p.out_proj
    return out, SSMState(conv_x=new_tail_x.to(state.conv_x.dtype),
                         conv_bc=new_tail_bc.to(state.conv_bc.dtype),
                         ssm=new_ssm)
