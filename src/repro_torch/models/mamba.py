"""Mamba2 (SSD, state-space duality) block, chunked-scan formulation: the
counterpart of ``src/repro/models/mamba.py``.

Prefill uses the chunked algorithm: within a chunk the output is an
attention-like masked product; across chunks a small recurrent state h
[B, heads, d_state, head_dim] is carried by a loop.  Decode is the O(1)
recurrent update.  ``use_kernel`` runs the chunked scan in the SSD-scan
kernel (K11, ``kernels.ssm_scan``); ``ssd_chunked`` here is the plain
path, which keeps the reference's arithmetic in the input dtype (its
cumulative log-decay and state included, so in bf16 it drifts from the
f32 kernel exactly as the reference's jnp path does).

Tensor parallelism (``launch.tp``): a mixer whose ``norm`` holds fewer
than ``d_inner`` channels holds the rank's SSD heads
(``launch.sharding._mamba_plan``): in_proj's columns are the rank's z, x
and dt beside the whole B and C (n_groups is below the axis's size), the
conv the rank's x channels beside B's and C's, ``A_log``, ``D`` and
``dt_bias`` the rank's heads.  The scan runs on the rank's heads, the
gated RMSNorm over the whole ``d_inner`` sums its squares over the
"model" axis first, and out_proj is row-parallel (one sum).  The decode
cache holds the rank's heads and conv channels.  In training the block's
input enters the region through ``tp.enter``, the norm's sum of squares
is summed over the axis backward too (it feeds each rank's own
channels), and the B|C pieces of in_proj, conv_w and conv_b, held whole
and used by each rank's heads, sum their gradients (``tp.sum_grad``).  (The reference's spec
cuts in_proj's concatenated columns contiguously, which splits no
quantity by head.)
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch import tp
from repro_torch.models.common import ParamSpec, Params, rmsnorm


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_specs(cfg: SSMConfig):
    d = cfg.d_model
    di, ds, ng, nh = cfg.d_inner, cfg.d_state, cfg.n_groups, cfg.n_heads
    proj_out = 2 * di + 2 * ng * ds + nh  # z | x | B | C | dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.d_conv, cfg.conv_dim), (None, "ssm_inner")),
        "conv_b": ParamSpec((cfg.conv_dim,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((nh,), (None,), init="ones"),
        "D": ParamSpec((nh,), (None,), init="ones"),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros"),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


class Mamba(Params):
    """A Mamba2 mixer's weights as a module: calling it runs
    ``mamba_forward``, so a forward hook sees each block's input."""

    def __init__(self, cfg: SSMConfig, tree):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, x, use_kernel=False):
        return mamba_forward(self, self.cfg, x, use_kernel=use_kernel)


def _local(cfg: SSMConfig, params):
    """(heads, d_inner) that ``params`` hold: the rank's under tensor
    parallelism, else the config's."""
    di = params["norm"].shape[-1]
    if not tp.sharded(di, cfg.d_inner):
        return cfg.n_heads, cfg.d_inner
    return di // cfg.head_dim, di


def _split_proj(cfg: SSMConfig, proj, di=None):
    di = cfg.d_inner if di is None else di
    conv_dim = di + 2 * cfg.n_groups * cfg.d_state
    z = proj[..., :di]
    xbc = proj[..., di:di + conv_dim]
    dt = proj[..., di + conv_dim:]
    return z, xbc, dt


def _split_xbc(cfg: SSMConfig, xbc, di=None):
    di = cfg.d_inner if di is None else di
    ds, ng = cfg.d_state, cfg.n_groups
    x = xbc[..., :di]
    bmat = xbc[..., di:di + ng * ds]
    cmat = xbc[..., di + ng * ds:]
    return x, bmat, cmat


def _gated_norm(cfg: SSMConfig, params, y, z):
    """``rmsnorm(y * silu(z))`` over the whole ``d_inner``: on the rank's
    channels the sum of squares is summed over the "model" axis."""
    g = y * F.silu(z)
    if g.shape[-1] == cfg.d_inner:
        return rmsnorm({"scale": params["norm"]}, g)
    ss = torch.sum(torch.square(g.float()), dim=-1, keepdim=True)
    var = tp.all_reduce_local(ss) / cfg.d_inner
    return ((g * torch.rsqrt(var + 1e-6)) * params["norm"]).to(g.dtype)


def _out_proj(cfg: SSMConfig, params, y):
    if y.shape[-1] == cfg.d_inner:
        return torch.einsum("bti,id->btd", y, params["out_proj"])
    return tp.all_reduce(tp.partial_mm(y, params["out_proj"]), y.dtype)


def _causal_conv(cfg: SSMConfig, params, xbc):
    """Depthwise causal conv1d over time.  xbc [B, T, conv_dim]."""
    w = params["conv_w"]  # [K, conv_dim]
    k = cfg.d_conv
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + params["conv_b"])


def ssd_chunked(cfg: SSMConfig, x, bmat, cmat, dt, h0=None,
                use_kernel=False):
    """Chunked SSD scan.

    x    [B, T, nh, hd]      (dt-scaled inputs)
    bmat [B, T, ng, ds]; cmat [B, T, ng, ds]; dt [B, T, nh] (the log
    decay alog = dt * A, A = -exp(A_log) folded in by the caller).
    Returns y [B, T, nh, hd] and the final state h [B, nh, ds, hd].
    """
    if use_kernel:
        from repro_torch.kernels.ssm_scan import ops as ssm_ops

        return ssm_ops.ssd_chunked(cfg, x, bmat, cmat, dt, h0)
    b, t, nh, hd = x.shape
    ng, ds = bmat.shape[2], bmat.shape[3]
    q = min(cfg.chunk, t)
    pad = (-t) % q
    if pad:
        # zero inputs and zero log-decay leave the state untouched
        def zf(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        x, bmat, cmat, dt = zf(x), zf(bmat), zf(cmat), zf(dt)
    tpad = t + pad
    nc = tpad // q
    rep = nh // ng

    xc = x.reshape(b, nc, q, nh, hd)
    bc = bmat.reshape(b, nc, q, ng, ds)
    cc = cmat.reshape(b, nc, q, ng, ds)
    al = dt.reshape(b, nc, q, nh)  # log decay per step (negative)
    cum = torch.cumsum(al, dim=2)  # [b, nc, q, nh]

    bc_h = torch.repeat_interleave(bc, rep, dim=3)  # [b,nc,q,nh,ds]
    cc_h = torch.repeat_interleave(cc, rep, dim=3)

    # intra-chunk: L[t,s] = exp(cum_t - cum_s) for s <= t, zeroed before
    # the exp above the diagonal
    lmask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                  device=x.device))[None, None, :, :, None]
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,q,q,nh]
    zero = torch.zeros((), dtype=ldiff.dtype, device=x.device)
    lfac = torch.where(lmask, torch.exp(torch.where(lmask, ldiff, zero)),
                       zero)
    cb = torch.einsum("bnqhs,bnphs->bnqph", cc_h, bc_h)  # [b,nc,q,q,nh]
    y_intra = torch.einsum("bnqph,bnphd->bnqhd", cb * lfac, xc)

    # chunk summaries: the state contribution of each chunk
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)  # [b,nc,q,nh]
    bx = torch.einsum("bnqhs,bnqhd->bnhsd", bc_h * decay_out[..., None], xc)

    # inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [b, nc, nh]
    h = h0 if h0 is not None else torch.zeros((b, nh, ds, hd),
                                              dtype=x.dtype, device=x.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)  # the state entering chunk n
        h = h * chunk_decay[:, n, :, None, None] + bx[:, n]
    h_in = torch.stack(h_in, dim=1)  # [b, nc, nh, ds, hd]

    decay_in = torch.exp(cum)  # [b,nc,q,nh]
    y_inter = torch.einsum("bnqhs,bnhsd->bnqhd", cc_h * decay_in[..., None],
                           h_in)
    y = (y_intra + y_inter).reshape(b, tpad, nh, hd)[:, :t]
    return y, h


def _region_params(cfg: SSMConfig, params, di: int):
    """The rank's mixer leaves under autograd: the B|C pieces (held
    whole) of in_proj's columns and of the conv's channels sum their
    gradients over the axis."""
    if not torch.is_grad_enabled():
        return params
    gs = 2 * cfg.n_groups * cfg.d_state
    out = {k: params[k] for k in params.keys()}
    out["in_proj"] = tp.sum_grad(out["in_proj"], ((2 * di, 2 * di + gs),))
    for k in ("conv_w", "conv_b"):
        out[k] = tp.sum_grad(out[k], ((di, di + gs),))
    return out


def mamba_forward(params, cfg: SSMConfig, x, use_kernel=False):
    """x [B, T, d] -> y [B, T, d] (prefill)."""
    nh, di = _local(cfg, params)
    if di != cfg.d_inner:
        x = tp.enter(x)
        params = _region_params(cfg, params, di)
    proj = torch.einsum("btd,dp->btp", x, params["in_proj"])
    z, xbc, dtr = _split_proj(cfg, proj, di)
    xbc = _causal_conv(cfg, params, xbc)
    xi, bmat, cmat = _split_xbc(cfg, xbc, di)
    b, t, _ = x.shape
    hd, ng, ds = cfg.head_dim, cfg.n_groups, cfg.d_state
    dt = F.softplus(dtr + params["dt_bias"])  # [B,T,nh]
    a = -torch.exp(params["A_log"])  # [nh]
    xh = xi.reshape(b, t, nh, hd) * dt[..., None]  # dt-scaled input
    alog = dt * a  # log decay
    y, _ = ssd_chunked(cfg, xh, bmat.reshape(b, t, ng, ds),
                       cmat.reshape(b, t, ng, ds), alog,
                       use_kernel=use_kernel)
    y = y + xi.reshape(b, t, nh, hd) * params["D"][:, None]
    y = y.reshape(b, t, di)
    return _out_proj(cfg, params, _gated_norm(cfg, params, y, z))


# ---------------------------------------------------------------------------
# Decode (O(1) recurrent step)
# ---------------------------------------------------------------------------


def mamba_init_cache(cfg: SSMConfig, batch: int, dtype, device=None,
                     heads=None):
    """The zero cache; ``heads``: the rank's SSD heads (default all), with
    their conv channels beside B's and C's."""
    nh = cfg.n_heads if heads is None else heads
    conv_dim = cfg.conv_dim - (cfg.n_heads - nh) * cfg.head_dim
    return {
        "h": torch.zeros((batch, nh, cfg.d_state, cfg.head_dim),
                         dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba_decode(params, cfg: SSMConfig, cache, x, pos):
    """x [B, 1, d] -> y [B, 1, d]; the state update in place of the scan.
    The new state and conv history replace the cache's entries."""
    del pos
    b = x.shape[0]
    nh, di = _local(cfg, params)
    hd, ng, ds = cfg.head_dim, cfg.n_groups, cfg.d_state
    proj = torch.einsum("btd,dp->btp", x, params["in_proj"])
    z, xbc, dtr = _split_proj(cfg, proj, di)
    # conv over [cached history | current]
    hist = torch.cat([cache["conv"], xbc], dim=1)  # [B, K, conv_dim]
    conv_out = torch.einsum("bkc,kc->bc", hist, params["conv_w"]) \
        + params["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :]
    xi, bmat, cmat = _split_xbc(cfg, xbc1, di)
    dt = F.softplus(dtr + params["dt_bias"])[:, 0]  # [B, nh]
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a)  # [B, nh]
    xh = xi.reshape(b, nh, hd) * dt[..., None]
    bm = torch.repeat_interleave(bmat.reshape(b, ng, ds), nh // ng, dim=1)
    cm = torch.repeat_interleave(cmat.reshape(b, ng, ds), nh // ng, dim=1)
    h = cache["h"] * decay[..., None, None] + torch.einsum(
        "bhs,bhd->bhsd", bm, xh)
    y = torch.einsum("bhs,bhsd->bhd", cm, h)
    y = y + xi.reshape(b, nh, hd) * params["D"][:, None]
    y = y.reshape(b, 1, di)
    y = _out_proj(cfg, params, _gated_norm(cfg, params, y, z))
    cache["h"], cache["conv"] = h, hist[:, 1:, :]
    return y, cache
