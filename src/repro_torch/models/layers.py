"""Model building blocks of the dense family: attention (GQA + RoPE)
with prefill/decode cache paths, the SwiGLU MLP, and RMSNorm.

The port of the dense part of :mod:`repro.models.layers`. Every
elementwise hot-spot routes through the saturated kernels in
:mod:`repro_torch.kernels.ops`; matmuls stay plain ``@`` products, as the
JAX package leaves them to XLA. There is no device mesh in this slice, so
heads are not padded and no sharding constraint is applied.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

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
