"""Model building blocks of the dense and ssm families: attention (GQA +
RoPE) with prefill/decode cache paths, the SwiGLU MLP, the Mamba2 (SSD)
block with its prefill/decode state paths, and RMSNorm.

The port of the dense and Mamba2 parts of :mod:`repro.models.layers`. Every
elementwise hot-spot routes through the saturated kernels in
:mod:`repro_torch.kernels.ops`; matmuls stay plain ``@`` products, as the
JAX package leaves them to XLA. There is no device mesh in this slice, so
heads are not padded and no sharding constraint is applied.
"""
from __future__ import annotations

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


def _qkv(p, x, cos, sin, cfg: ModelConfig):
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    if cos is not None:
        q = ops.rotary(q, cos[:, None], sin[:, None]).to(x.dtype)
        k = ops.rotary(k, cos[:, None], sin[:, None]).to(x.dtype)
    return q, k, v


def attn_apply(p, x, cos, sin, cfg: ModelConfig, *, causal=True):
    """Full-sequence self-attention."""
    q, k, v = _qkv(p, x, cos, sin, cfg)
    o = ops.attention(q, k, v, causal=causal)
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
    returned."""
    k_c, v_c = kv_cache
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


def mlp_init(gen, cfg: ModelConfig, device):
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r} (the gelu MLP comes "
                                  "with whisper, ROADMAP queue A)")
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": dense_init(gen, (d, f), cfg.dtype, device),
            "wu": dense_init(gen, (d, f), cfg.dtype, device),
            "wd": dense_init(gen, (f, d), cfg.dtype, device,
                             scale=init_std_out(f, cfg.n_layers))}


def mlp_apply(p, x, cfg: ModelConfig):
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r}")
    return ops.swiglu(x @ p["wg"], x @ p["wu"]) @ p["wd"]


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
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} (layernorm comes "
                                  "with whisper, ROADMAP queue A)")
    return {"g": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device)}


def norm_apply(p, x, cfg: ModelConfig):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r}")
    out = ops.rmsnorm(x.float(), p["g"].float())
    return out.to(x.dtype)
