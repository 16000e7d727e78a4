"""Model building blocks of every family of the port: attention (GQA +
RoPE, or cross-attention over encoder states) with prefill/decode cache
paths, the SwiGLU and GELU MLPs, the capacity-sorted MoE, the Mamba2
(SSD) block with its prefill/decode state paths, RMSNorm and LayerNorm.

The port of :mod:`repro.models.layers` (its jnp ``blocked_attention`` and
training's backward aside).
Every elementwise hot-spot routes through the saturated kernels in
:mod:`repro_torch.kernels.ops`; matmuls stay plain ``@`` products, as the
JAX package leaves them to XLA. There is no device mesh in the port yet,
so heads are not padded and no sharding constraint is applied.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .common import ModelConfig, dense_init, init_std_out


def attn_init(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": dense_init(gen, (d, qd), cfg.dtype, device),
        "wk": dense_init(gen, (d, kvd), cfg.dtype, device),
        "wv": dense_init(gen, (d, kvd), cfg.dtype, device),
        "wo": dense_init(gen, (qd, d), cfg.dtype, device,
                         scale=init_std_out(qd, cfg.n_layers)),
    }


def _split_heads(x, n_heads, head_dim):
    """(B, S, n*hd) -> contiguous (B, n, S, hd), the layout the kernels
    take."""
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, head_dim).transpose(1, 2).contiguous()


def _merge_heads(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _qkv(p, x, cos, sin, cfg: ModelConfig, kv_x=None):
    """q from ``x``; k and v from ``kv_x`` (encoder states) where given,
    else from ``x``. RoPE applies to self-attention only."""
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(src @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(src @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    if cos is not None and kv_x is None:
        q = ops.rotary(q, cos[:, None], sin[:, None]).to(x.dtype)
        k = ops.rotary(k, cos[:, None], sin[:, None]).to(x.dtype)
    return q, k, v


def attn_apply(p, x, cos, sin, cfg: ModelConfig, *, causal=True,
               kv_x: Optional[torch.Tensor] = None):
    """Full-sequence attention. ``kv_x`` (encoder states) makes it
    cross-attention: k and v from ``kv_x``, no RoPE, never causal."""
    q, k, v = _qkv(p, x, cos, sin, cfg, kv_x)
    o = ops.attention(q, k, v, causal=causal and kv_x is None)
    return _merge_heads(o) @ p["wo"]


def attn_prefill(p, x, cos, sin, cfg: ModelConfig):
    """Returns (out, (k, v)) for the decode cache."""
    q, k, v = _qkv(p, x, cos, sin, cfg)
    o = ops.attention(q, k, v, causal=True)
    return _merge_heads(o) @ p["wo"], (k, v)


def attn_decode(p, x1, kv_cache, pos: int, cfg: ModelConfig,
                cos1=None, sin1=None):
    """One-token decode. x1:(B,1,D); kv_cache: (k,v) each (B,KH,S,hd);
    pos: current position. The JAX version returns an updated copy of the
    cache (``lax.dynamic_update_slice``); here the new key and value are
    written into the cache tensors in place, and the same tensors are
    returned. A ``pos`` past the cache raises ``ValueError``: the JAX
    update clamps it to the last slot, and a torch slice past the end
    would drop the new key and value without a word."""
    k_c, v_c = kv_cache
    if pos >= k_c.shape[2]:
        raise ValueError(f"attn_decode: position {pos} is past the KV "
                         f"cache of length {k_c.shape[2]}")
    q, k1, v1 = _qkv(p, x1, cos1, sin1, cfg)
    k_c[:, :, pos:pos + 1] = k1.to(k_c.dtype)
    v_c[:, :, pos:pos + 1] = v1.to(v_c.dtype)
    S = k_c.shape[2]
    valid = torch.arange(S, device=k_c.device) <= pos
    scale = cfg.head_dim ** -0.5
    KH = cfg.n_kv_heads
    rep = cfg.n_heads // KH
    B = q.shape[0]
    # GQA-grouped einsum: never materialize the head-repeated KV cache
    qg = q.reshape(B, KH, rep, 1, cfg.head_dim)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k_c.float()) * scale
    logits = torch.where(valid, logits, -1e30)
    # Mirror the flash kernel's order of operations exactly — unnormalized
    # exp weights cast to the value dtype, PV accumulated in f32, then the
    # f32 normalizer applied — so decode reproduces teacher-forcing logits
    # instead of drifting one bf16 ulp per layer.
    m = torch.amax(logits, -1, keepdim=True)
    pmat = torch.exp(logits - m)
    l = pmat.sum(-1, keepdim=True)
    v_r = v_c.to(x1.dtype)
    acc = torch.einsum("bkgqs,bksd->bkgqd", pmat.to(v_r.dtype).float(),
                       v_r.float())
    o = (acc / l).to(x1.dtype)
    o = o.reshape(B, cfg.n_heads, 1, cfg.head_dim)
    return _merge_heads(o) @ p["wo"], (k_c, v_c)


def mlp_init(gen, cfg: ModelConfig, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    names = ("wg", "wu") if cfg.act == "swiglu" else ("wi",)
    p = {n: dense_init(gen, (d, f), cfg.dtype, device) for n in names}
    p["wd"] = dense_init(gen, (f, d), cfg.dtype, device,
                         scale=init_std_out(f, cfg.n_layers))
    return p


def mlp_apply(p, x, cfg: ModelConfig):
    if cfg.act == "swiglu":
        return ops.swiglu(x @ p["wg"], x @ p["wu"]) @ p["wd"]
    return ops.gelu(x @ p["wi"]) @ p["wd"]


# ---------------------------------------------------------------------------
# MoE (capacity-based sorted dispatch)
# ---------------------------------------------------------------------------
def moe_init(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    mc = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, mc.n_experts
    p = {"router": dense_init(gen, (d, e), torch.float32, device),
         "wg": dense_init(gen, (e, d, f), cfg.dtype, device),
         "wu": dense_init(gen, (e, d, f), cfg.dtype, device),
         "wd": dense_init(gen, (e, f, d), cfg.dtype, device,
                          scale=init_std_out(f, cfg.n_layers))}
    if mc.residual_ffn_dim:
        p["res"] = mlp_init(gen, cfg, device, d_ff=mc.residual_ffn_dim)
    return p


def moe_apply(p, x, cfg: ModelConfig):
    """Grouped token-capacity MoE (GShard-style, dropless up to the
    capacity factor), as the JAX ``moe_apply``: the tokens split into G
    groups, each token's top-k experts, each expert taking at most C
    tokens of a group in token order (the rest dropped). Returns
    ``(out, aux)``, aux the load-balancing loss.

    The expert products run as one batched product per weight, experts
    leading ((E, G*C, D) @ (E, D, F)); the JAX einsums compute the same
    sums. The combine adds each token's K weighted expert outputs with
    ``index_add_`` into the model dtype, as the JAX ``.at[tok].add``. On
    CUDA that add uses atomics, which sum a token's contributions in an
    order that changes from run to run, so a bf16 result may differ by a
    rounding between runs; f32 comparisons are unaffected beyond
    summation order."""
    mc = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = mc.n_experts, mc.top_k
    G = 32
    while T % G:
        G //= 2
    TG = T // G
    C = max(int(math.ceil(TG * K / E * mc.capacity_factor)), 1)
    dev = x.device
    xf = x.reshape(G, TG, D)
    logits = xf.float() @ p["router"]                   # (G,TG,E)
    probs = ops.moe_router_probs(logits)                # saturated softmax
    wts, idx = torch.topk(probs, K, dim=-1)             # (G,TG,K)
    wts = wts / torch.clamp(wts.sum(-1, keepdim=True), min=1e-9)

    fe = idx.reshape(G, TG * K)                         # expert ids
    # a stable sort, as jnp.argsort: slots of one expert stay in token
    # order, so the same tokens overflow the capacity
    order = torch.argsort(fe, dim=-1, stable=True)      # (G,TG*K)
    garange = torch.arange(G, device=dev)[:, None]
    counts = torch.bincount((fe + E * garange).reshape(-1),
                            minlength=G * E).reshape(G, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    eidx = torch.arange(E, device=dev).repeat_interleave(C)   # (E*C,)
    cpos = torch.arange(C, device=dev).repeat(E)
    gpos = starts[:, eidx] + cpos[None]                 # (G,E*C)
    valid = cpos[None] < counts[:, eidx]                # (G,E*C)
    # an empty capacity slot reads sorted slot 0 and carries weight 0
    gpos = torch.where(valid, gpos, 0)
    slot = torch.gather(order, 1, gpos)                 # (G,E*C) into TG*K
    tok = torch.div(slot, K, rounding_mode="floor")     # (G,E*C) into TG

    xg = xf[garange, tok] * valid[..., None].to(xf.dtype)     # (G,E*C,D)
    xe = xg.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    a = ops.swiglu(torch.bmm(xe, p["wg"]), torch.bmm(xe, p["wu"]))
    y = torch.bmm(a, p["wd"])                           # (E,G*C,D)
    y = y.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    w_flat = torch.gather(wts.reshape(G, TG * K), 1, slot)
    y = y * (w_flat * valid)[..., None].to(y.dtype)
    out = torch.zeros((G * TG, D), dtype=x.dtype, device=dev)
    out.index_add_(0, (tok + TG * garange).reshape(-1),
                   y.reshape(G * E * C, D).to(x.dtype))
    out = out.reshape(G, TG, D)
    # router aux loss (load balancing)
    me = probs.mean((0, 1))                             # (E,)
    ce = counts.sum(0).float() / (T * K)
    aux = E * torch.sum(me * ce)
    if mc.residual_ffn_dim:
        out = out + mlp_apply(p["res"], xf, cfg)
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------
def mamba_init(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    """Separate per-stream projections (z/x/B/C/dt), as the JAX init."""
    sc = cfg.ssm
    d = cfg.d_model
    di, nh, N = sc.d_inner(d), sc.n_heads(d), sc.state_dim
    f32 = torch.float32
    return {
        "w_z": dense_init(gen, (d, di), cfg.dtype, device),
        "w_x": dense_init(gen, (d, di), cfg.dtype, device),
        "w_B": dense_init(gen, (d, N), cfg.dtype, device),
        "w_C": dense_init(gen, (d, N), cfg.dtype, device),
        "w_dt": dense_init(gen, (d, nh), cfg.dtype, device),
        "w_out": dense_init(gen, (di, d), cfg.dtype, device,
                            scale=init_std_out(di, cfg.n_layers)),
        "conv_x": dense_init(gen, (sc.conv_width, di), cfg.dtype, device,
                             scale=0.5),
        "conv_b": dense_init(gen, (sc.conv_width, N), cfg.dtype, device,
                             scale=0.5),
        "conv_c": dense_init(gen, (sc.conv_width, N), cfg.dtype, device,
                             scale=0.5),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=f32,
                                        device=device)),
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.rand((nh,), generator=gen, dtype=f32,
                              device=device) * 3.0 - 4.0,   # U(-4, -1)
        "norm_g": torch.ones((di,), dtype=cfg.dtype, device=device),
    }


def _causal_conv(u, w):
    """Depthwise causal conv. u:(B,S,Ch) w:(W,Ch)."""
    W = w.shape[0]
    pads = F.pad(u, (0, 0, W - 1, 0))
    out = torch.zeros_like(u)
    for t in range(W):
        out = out + pads[:, t:t + u.shape[1]] * w[t]
    return out


def _mamba_proj(p, x, cfg: ModelConfig):
    """Input projections: z, xs, b, c, dt_raw (separate streams)."""
    return x @ p["w_z"], x @ p["w_x"], x @ p["w_B"], x @ p["w_C"], \
        x @ p["w_dt"]


def _silu(u):
    return u * torch.sigmoid(u)


def mamba_apply(p, x, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None):
    """Full-sequence Mamba2 block. x:(B,S,D) -> (B,S,D).

    With ``state`` (one layer's views of the decode cache from
    :func:`mamba_init_state`) this is the prefill: the last ``W-1`` inputs
    of each conv stream and the scan's final SSM state are written into
    it in place, ready for :func:`mamba_decode`."""
    sc = cfg.ssm
    B, S, _ = x.shape
    di, nh = sc.d_inner(cfg.d_model), sc.n_heads(cfg.d_model)
    z, xs, b, c, dt_raw = _mamba_proj(p, x, cfg)
    if state is not None:
        w = min(sc.conv_width - 1, S)
        for name, u in (("conv_x", xs), ("conv_b", b), ("conv_c", c)):
            state[name][:, state[name].shape[1] - w:] = u[:, S - w:]
    xs = _silu(_causal_conv(xs, p["conv_x"]))
    b_mat = _silu(_causal_conv(b, p["conv_b"])).float()
    c_mat = _silu(_causal_conv(c, p["conv_c"])).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (B,S,nh)
    out = ops.ssd(xs.reshape(B, S, nh, sc.head_dim).float(), dt, p["a_log"],
                  b_mat, c_mat, p["d_skip"], chunk=sc.chunk,
                  return_state=state is not None)
    if state is not None:
        out, h_final = out
        state["h"].copy_(h_final)
    y = out.reshape(B, S, di).to(x.dtype)
    return ops.rmsnorm_gated(y, z, p["norm_g"]) @ p["w_out"]


def mamba_init_state(cfg: ModelConfig, n_layers: int, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zero decode state of ``n_layers`` Mamba2 blocks, stacked on a
    leading axis: the f32 SSM state and the last ``W-1`` inputs of each
    conv stream."""
    sc = cfg.ssm
    d = cfg.d_model
    di, nh, N = sc.d_inner(d), sc.n_heads(d), sc.state_dim
    W1 = sc.conv_width - 1

    def zeros(*shape, dtype=dtype):
        return torch.zeros((n_layers, batch) + shape, dtype=dtype,
                           device=device)

    return {"h": zeros(nh, N, sc.head_dim, dtype=torch.float32),
            "conv_x": zeros(W1, di), "conv_b": zeros(W1, N),
            "conv_c": zeros(W1, N)}


def mamba_decode(p, x1, state: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One-token recurrent step. x1:(B,1,D); state: one layer's views of
    the cache from :func:`mamba_init_state`. The JAX version returns a
    new state; here the conv histories and the SSM state are updated in
    the given tensors in place, and the same dict is returned."""
    sc = cfg.ssm
    B = x1.shape[0]
    di, nh = sc.d_inner(cfg.d_model), sc.n_heads(cfg.d_model)
    z, xs, b, c, dt_raw = _mamba_proj(p, x1, cfg)

    def conv_step(name, new, w):
        hist = torch.cat([state[name], new], dim=1)            # (B,W,Ch)
        out = torch.einsum("bwc,wc->bc", hist, w)[:, None]
        state[name].copy_(hist[:, 1:])
        return _silu(out)

    xs_c = conv_step("conv_x", xs, p["conv_x"])
    b_t = conv_step("conv_b", b, p["conv_b"])[:, 0].float()
    c_t = conv_step("conv_c", c, p["conv_c"])[:, 0].float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    h, y = ops.ssd_decode(state["h"],
                          xs_c[:, 0].reshape(B, nh, sc.head_dim).float(),
                          dt, p["a_log"], b_t, c_t, p["d_skip"])
    state["h"].copy_(h)
    y = y.reshape(B, 1, di).to(x1.dtype)
    return ops.rmsnorm_gated(y, z, p["norm_g"]) @ p["w_out"], state


def norm_init(cfg: ModelConfig, device):
    g = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device)
    if cfg.norm == "layernorm":
        return {"g": g, "b": torch.zeros_like(g)}
    return {"g": g}


def norm_apply(p, x, cfg: ModelConfig):
    """RMSNorm or LayerNorm in f32 math, cast back to ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        out = ops.layernorm(xf, p["g"].float(), p["b"].float())
    else:
        out = ops.rmsnorm(xf, p["g"].float())
    return out.to(x.dtype)
