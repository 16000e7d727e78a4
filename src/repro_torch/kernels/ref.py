"""Plain torch oracles for every tile op and for attention.

The port of :mod:`repro.kernels.ref`: the ground truth of the tests and
the floor the ops layer falls back to on CPU tensors (``ops._REF_FNS``).
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x, g, eps=1e-6):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * g


def rmsnorm_gated_ref(x, z, g, eps=1e-6):
    xg = x * (z * torch.sigmoid(z))
    var = torch.mean(torch.square(xg), dim=-1, keepdim=True)
    return xg * torch.rsqrt(var + eps) * g


def layernorm_ref(x, g, b, eps=1e-6):
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g + b


def swiglu_ref(a, b):
    return a * torch.sigmoid(a) * b


def gelu_ref(a):
    return 0.5 * a * (1.0 + torch.tanh(
        0.7978845608028654 * (a + 0.044715 * a ** 3)))


def rotate_half_ref(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def rotary_ref(q, cos, sin):
    return q * cos + rotate_half_ref(q) * sin


def residual_scale_ref(x, y, alpha=1.0):
    return x + alpha * y


def softmax_ref(x):
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def adamw_ref(param, grad, m, v, *, lr, b1, b2, eps, wd, inv_bc1, inv_bc2):
    m_new = b1 * m + (1.0 - b1) * grad
    v_new = b2 * v + (1.0 - b2) * grad * grad
    mhat = m_new * inv_bc1
    vhat = v_new * inv_bc2
    update = mhat / (torch.sqrt(vhat) + eps) + wd * param
    return m_new, v_new, param - lr * update


def sgd_momentum_ref(param, grad, m, *, lr, mu):
    m_new = mu * m + grad
    return m_new, param - lr * m_new


def ssd_gate_ref(dt_raw, a_log, *, bias=0.0):
    dt = torch.nn.functional.softplus(dt_raw + bias)
    decay = torch.exp(dt * (-torch.exp(a_log)))
    return dt, decay


def l2_clip_ref(g, *, norm, max_norm, eps=1e-9):
    scale = min(1.0, max_norm / (norm + eps))
    return g * scale


def attention_ref(q, k, v, *, causal=True, scale=None):
    """Masked softmax attention. q:(B,H,S,D) k/v:(B,KH,S,D); GQA by
    repeat. Logits and softmax in f32; probabilities are cast to the
    value dtype before the PV product, which accumulates in f32."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    if KH != H:
        rep = H // KH
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = (D ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return o.to(q.dtype)
