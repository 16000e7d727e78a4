"""Model building blocks of every family of the port: attention (GQA +
RoPE, or cross-attention over encoder states) with prefill/decode cache
paths, the SwiGLU and GELU MLPs, the capacity-sorted MoE, the Mamba2
(SSD) block with its prefill/decode state paths, RMSNorm and LayerNorm.

The port of :mod:`repro.models.layers` (its jnp ``blocked_attention`` and
training's backward aside).
Every elementwise hot-spot routes through the saturated kernels in
:mod:`repro_torch.kernels.ops`; matmuls stay plain ``@`` products, as the
JAX package leaves them to XLA. Under an active mesh
(:mod:`repro_torch.parallel.ctx`) the parameters are DTensors: the
heads are padded to the model axis in the weights and activations are
constrained at the reference's sites; without one both are no-ops.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel import ctx
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


def _padded_H(cfg: ModelConfig) -> int:
    """Attention heads padded to the model axis, as the reference pads
    them: the padding lives in the weights (zero ``wq`` columns, zero
    ``wo`` rows), so results stay exact; without a mesh, the heads."""
    tp = ctx.tp_size()
    return ((cfg.n_heads + tp - 1) // tp) * tp


def _wq_padded(p, cfg: ModelConfig, Hp: int):
    """``wq`` and ``wo`` with ``Hp - n_heads`` zero heads appended. A
    sharded weight's head columns (rows) move between ranks: each model
    rank pads the gathered weight and keeps its share of the padded
    heads (:func:`_padded_shard`)."""
    if Hp == cfg.n_heads:
        return p["wq"], p["wo"]
    extra = (Hp - cfg.n_heads) * cfg.head_dim
    if not ctx.is_dtensor(p["wq"]):
        return (F.pad(p["wq"], (0, extra)), F.pad(p["wo"], (0, 0, 0, extra)))
    return _padded_shard(p["wq"], 1, extra), _padded_shard(p["wo"], 0, extra)


def _padded_shard(w, dim: int, extra: int):
    """The DTensor ``w`` with ``extra`` zero columns (``dim`` 1) or rows
    (``dim`` 0) appended, placed as ``w``, in a ``local_map`` region: the
    weight gathered whole over the model axis, padded, this model rank's
    slice of the padded dimension kept (its gradient a ``Partial`` sum
    over the model axis: each rank's slice feeds it)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    tp = list(mesh.mesh_dim_names).index("model")
    pl = tuple(w.placements)
    whole = tuple(Replicate() if i == tp else q for i, q in enumerate(pl))
    grad = tuple(Partial() if i == tp else q for i, q in enumerate(pl))
    split = pl[tp].is_shard() and pl[tp].dim == dim

    def pad(w):
        pads = (0, extra) if dim == 1 else (0, 0, 0, extra)
        w = F.pad(w, pads)
        if not split:
            return w
        n = w.shape[dim] // mesh.size(tp)
        return w.narrow(dim, mesh.get_local_rank(tp) * n, n).contiguous()
    return local_map(pad, out_placements=(pl,), in_placements=(whole,),
                     in_grad_placements=(grad if split else whole,),
                     device_mesh=mesh, redistribute_inputs=True)(w)


def _pad_heads_kv(k, v, H: int, Hp: int):
    """k and v for ``Hp`` query heads sharded over the model axis. The
    reference repeats GQA's kv heads to ``H`` and pads them to ``Hp``
    before the head-shard constraint; the port's flash kernel maps each
    query head to its kv head itself, so k and v keep their ``KH`` heads
    wherever a shard of the query heads holds whole groups (``Hp == H``
    and ``KH`` divisible by the model axis: every case without a mesh)
    and are repeated and padded as the reference's otherwise."""
    KH = k.shape[1]
    if ctx.is_dtensor(k) and (Hp != H or KH % ctx.tp_size()):
        return (_expand_heads(k, H, Hp), _expand_heads(v, H, Hp))
    return (ctx.constrain(k, "dp", "tp", None, None),
            ctx.constrain(v, "dp", "tp", None, None))


def _expands(p, cfg: ModelConfig, Hp: int) -> bool:
    """Whether k and v must be repeated and padded to the query heads: a
    shard of the ``Hp`` query heads would not hold whole kv groups."""
    return ctx.is_dtensor(p["wk"]) and (
        Hp != cfg.n_heads or cfg.n_kv_heads % ctx.tp_size())


def _repeat_pad_slice(t, H: int, Hp: int, r: int, n: int):
    """k or v (B, KH, S, hd) repeated to ``H`` heads, padded to ``Hp``,
    and the ``n`` heads of model rank ``r`` kept."""
    KH = t.shape[1]
    if KH != H:
        t = torch.repeat_interleave(t, H // KH, dim=1)
    if Hp != H:
        t = F.pad(t, (0, 0, 0, 0, 0, Hp - H))
    return t[:, r * n:(r + 1) * n].contiguous()


def _expand_heads(t, H: int, Hp: int):
    """k or v (B, KH, S, hd) repeated to ``H`` heads and padded to
    ``Hp``, in a ``local_map`` region: each data rank's rows, each model
    rank keeping its ``Hp / tp`` heads of the result (its gradient a
    ``Partial`` sum over the model axis: each rank's heads feed it)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    t = ctx.constrain(t, "dp", None, None, None)
    mesh = t.device_mesh
    tp = list(mesh.mesh_dim_names).index("model")
    n = Hp // mesh.size(tp)

    def expand(t):
        return _repeat_pad_slice(t, H, Hp, mesh.get_local_rank(tp), n)
    pl = tuple(t.placements)
    out = tuple(Shard(1) if i == tp else p for i, p in enumerate(pl))
    grad = tuple(Partial() if i == tp else p for i, p in enumerate(pl))
    return local_map(expand, out_placements=(out,), in_placements=(pl,),
                     in_grad_placements=(grad,), device_mesh=mesh)(t)


def _kv_expanded(p, src, rope, cfg: ModelConfig, Hp: int):
    """k and v for ``Hp`` query heads sharded over the model axis where
    :func:`_expands`: the projections of ``src`` (B, S, D, whole along
    the sequence), RoPE (``rope``: cos and sin, or None) and the repeat
    and padding of :func:`_expand_heads`, in one ``local_map`` region on
    each data rank's rows, each model rank keeping its heads. Its
    backward is the region's own: the gradients of ``src``, ``wk`` and
    ``wv`` leave it as ``Partial`` sums over the model axis (each rank's
    heads feed them) and, for the weights, over the data axes, so no
    gradient's placement between the projections and the expansion is
    left to DTensor's propagation, whose choice there differs between
    torch versions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = src.device_mesh
    tp = list(mesh.mesh_dim_names).index("model")
    n = Hp // mesh.size(tp)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = tuple(Shard(0) if q.is_shard() and q.dim == 0 and i != tp
                 else Replicate() for i, q in enumerate(src.placements))
    whole = (Replicate(),) * mesh.ndim
    src_grad = tuple(Partial() if i == tp else q for i, q in enumerate(rows))
    w_grad = tuple(Partial() if i == tp or q.is_shard() else q
                   for i, q in enumerate(rows))
    out = tuple(Shard(1) if i == tp else q for i, q in enumerate(rows))
    tabs, tab_pl = (), ()
    if rope is not None:
        # a table as long as the batch follows its rows; (1, S, hd) ones
        # are replicated
        tabs = tuple(ctx.like(src, t) for t in rope)
        tab_pl = tuple(rows if t.shape[0] == src.shape[0] else whole
                       for t in tabs)

    def project(src, wk, wv, *tabs):
        B, S, _ = src.shape
        r = mesh.get_local_rank(tp)
        k = (src @ wk).reshape(B, S, KH, hd).transpose(1, 2).contiguous()
        v = (src @ wv).reshape(B, S, KH, hd).transpose(1, 2).contiguous()
        if tabs:
            cos, sin = tabs
            k = ops.rotary(k, cos[:, None], sin[:, None]).to(src.dtype)
        return (_repeat_pad_slice(k, H, Hp, r, n),
                _repeat_pad_slice(v, H, Hp, r, n))
    return local_map(
        project, out_placements=(out, out),
        in_placements=(rows, whole, whole, *tab_pl),
        in_grad_placements=(src_grad, w_grad, w_grad, *tab_pl),
        device_mesh=mesh, redistribute_inputs=True)(
            src, p["wk"], p["wv"], *tabs)


def _gathered(x):
    """A block's input (B, S, D) whole along the sequence (one all-gather
    of a sequence-sharded residual), before its projections: each
    product would gather it again, and so would their backward."""
    return ctx.constrain(x, "dp", None, None)


def _block_out(y, cfg: ModelConfig):
    """A block's output (B, S, D) placed as the residual it is added to:
    a row-parallel product's ``Partial`` sum reduce-scattered over the
    sequence (``seq_shard``), or all-reduced, as GSPMD places it."""
    return ctx.constrain(y, "dp", "tp" if cfg.seq_shard else None, None)


def _split_heads(x, n_heads, head_dim):
    """(B, S, n*hd) -> contiguous (B, n, S, hd), the layout the kernels
    take."""
    B, S, _ = x.shape
    if n_heads % ctx.tp_size():
        # heads that do not split over the model axis (the decode tick's
        # unpadded ones): the projection is gathered whole first
        x = ctx.constrain(x, "dp", None, None)
    return x.reshape(B, S, n_heads, head_dim).transpose(1, 2).contiguous()


def _merge_heads(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _qkv(p, x, cos, sin, cfg: ModelConfig, kv_x=None, wq=None, Hp=None,
         expand: bool = False):
    """q from ``x``; k and v from ``kv_x`` (encoder states) where given,
    else from ``x``. RoPE applies to self-attention only. ``wq`` and
    ``Hp``: the head-padded weight and head count (default: unpadded).
    ``expand``: k and v come back expanded to the query heads' shards
    where :func:`_expands` (:func:`_kv_expanded`)."""
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ (p["wq"] if wq is None else wq), Hp or cfg.n_heads,
                     cfg.head_dim)
    if expand and _expands(p, cfg, Hp or cfg.n_heads):
        rope = (cos, sin) if cos is not None and kv_x is None else None
        k, v = _kv_expanded(p, src, rope, cfg, Hp or cfg.n_heads)
        if rope is not None:
            q = ops.rotary(q, cos[:, None], sin[:, None]).to(x.dtype)
        return q, k, v
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
    Hp = _padded_H(cfg) if ctx.is_dtensor(p["wq"]) else cfg.n_heads
    wq, wo = _wq_padded(p, cfg, Hp)
    x = _gathered(x)
    kv_x = None if kv_x is None else _gathered(kv_x)
    q, k, v = _qkv(p, x, cos, sin, cfg, kv_x, wq, Hp, expand=True)
    q = ctx.constrain(q, "dp", "tp", None, None)
    if not _expands(p, cfg, Hp):
        k, v = _pad_heads_kv(k, v, cfg.n_heads, Hp)
    o = ops.attention(q, k, v, causal=causal and kv_x is None)
    return _block_out(_merge_heads(o) @ wo, cfg)


def attn_prefill(p, x, cos, sin, cfg: ModelConfig):
    """Returns (out, (k, v)) for the decode cache."""
    Hp = _padded_H(cfg) if ctx.is_dtensor(p["wq"]) else cfg.n_heads
    wq, wo = _wq_padded(p, cfg, Hp)
    q, k, v = _qkv(p, x, cos, sin, cfg, None, wq, Hp)
    q = ctx.constrain(q, "dp", "tp", None, None)
    kp, vp = _pad_heads_kv(k, v, cfg.n_heads, Hp)
    o = ops.attention(q, kp, vp, causal=True)
    return _merge_heads(o) @ wo, (k, v)


def write_prefix(buf, i: int, x):
    """``buf[i, :, :, :S] = x``: a prefill's k or v (B, KH, S, hd) into
    slot ``i`` of a stacked cache (L, B, KH, S_max, hd). A DTensor cache
    (placed by ``cache_specs``) is written where it lies: ``x`` is placed
    as the slot, whole along the sequence, and each rank copies the
    positions of its slice of the cache."""
    S = x.shape[2]
    if not ctx.is_dtensor(buf):
        buf[i, :, :, :S] = x
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    pl = buf.placements
    x = ctx.like(buf, x).redistribute(mesh, tuple(
        Shard(q.dim - 1) if q.is_shard() and q.dim in (1, 2, 4)
        else Replicate() for q in pl)).to_local()
    local = buf.to_local()
    n = local.shape[3]
    s0 = sum(mesh.get_local_rank(d) * n for d, q in enumerate(pl)
             if q.is_shard() and q.dim == 3)
    a, b = s0, min(s0 + n, S)
    if a < b:
        local[i, :, :, :b - a] = x[:, :, a:b]


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
    if ctx.is_dtensor(k_c):
        o = _sharded_decode(q, k1, v1, k_c, v_c, pos, cfg)
        o = ctx.constrain(o, "dp", None, None, None)
        return _merge_heads(o) @ p["wo"], (k_c, v_c)
    k_c[:, :, pos:pos + 1] = k1.to(k_c.dtype)
    v_c[:, :, pos:pos + 1] = v1.to(v_c.dtype)
    valid = torch.arange(k_c.shape[2], device=k_c.device) <= pos
    o = _decode_attend(q, k_c, v_c, valid, cfg.head_dim ** -0.5, x1.dtype)
    return _merge_heads(o) @ p["wo"], (k_c, v_c)


def _decode_attend(q, k_c, v_c, valid, scale: float, dtype, reduce=None):
    """One query token (B, H, 1, hd) against the cache (B, KH, S, hd),
    positions where ``valid``. ``reduce`` (max, sum): the all-reduces
    that combine the row max, the normalizer and the weighted values of
    a cache whose sequence is split over ranks; None for a whole one."""
    B, H, _, hd = q.shape
    KH = k_c.shape[1]
    rep = H // KH
    # GQA-grouped einsum: never materialize the head-repeated KV cache
    qg = q.reshape(B, KH, rep, 1, hd)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                          k_c.float()) * scale
    logits = torch.where(valid, logits, -1e30)
    # Mirror the flash kernel's order of operations exactly — unnormalized
    # exp weights cast to the value dtype, PV accumulated in f32, then the
    # f32 normalizer applied — so decode reproduces teacher-forcing logits
    # instead of drifting one bf16 ulp per layer.
    m = torch.amax(logits, -1, keepdim=True)
    if reduce is not None:
        m = reduce[0](m)
    pmat = torch.exp(logits - m)
    l = pmat.sum(-1, keepdim=True)
    v_r = v_c.to(dtype)
    acc = torch.einsum("bkgqs,bksd->bkgqd", pmat.to(v_r.dtype).float(),
                       v_r.float())
    if reduce is not None:
        l, acc = reduce[1](l), reduce[1](acc)
    return (acc / l).to(dtype).reshape(B, H, 1, hd)


def _sharded_decode(q, k1, v1, k_c, v_c, pos: int, cfg: ModelConfig):
    """The decode tick's cache write and attention on DTensors, in a
    ``local_map`` region with the reference's placements: the cache's
    batch over the data axes and its kv heads over the model axis where
    they divide (each rank attends with its heads' queries), else its
    sequence (each rank attends over its slice of the positions, the row
    max, normalizer and values all-reduced over the model axis, as GSPMD
    reduces the reference's logits sharded ``(dp, None, None, None,
    tp)``). Returns the attention output (B, H, 1, hd), heads over the
    model axis where the cache's are."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map
    mesh = k_c.device_mesh
    names = list(mesh.mesh_dim_names)
    tp = names.index("model") if "model" in names else None
    pl = k_c.placements
    by_seq = tp is not None and pl[tp].is_shard() and pl[tp].dim == 2
    heads = None if by_seq or tp is None or not pl[tp].is_shard() else "tp"
    q, k1, v1 = (ctx.constrain(t, "dp", heads, None, None)
                 for t in (q, k1, v1))
    scale = cfg.head_dim ** -0.5

    def attend(q, k1, v1, k_c, v_c):
        S = k_c.shape[2]
        s0 = mesh.get_local_rank(tp) * S if by_seq else 0
        if s0 <= pos < s0 + S:
            k_c[:, :, pos - s0] = k1[:, :, 0].to(k_c.dtype)
            v_c[:, :, pos - s0] = v1[:, :, 0].to(v_c.dtype)
        valid = torch.arange(s0, s0 + S, device=k_c.device) <= pos
        reduce = None
        if by_seq:
            reduce = tuple(
                lambda t, op=op: funcol.wait_tensor(
                    funcol.all_reduce(t, op, (mesh, tp)))
                for op in ("max", "sum"))
        return _decode_attend(q, k_c, v_c, valid, scale, q.dtype, reduce)

    return local_map(attend, out_placements=(q.placements,),
                     in_placements=(q.placements, k1.placements,
                                    v1.placements, pl, pl),
                     device_mesh=mesh)(q, k1, v1, k_c, v_c)


def mlp_init(gen, cfg: ModelConfig, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    names = ("wg", "wu") if cfg.act == "swiglu" else ("wi",)
    p = {n: dense_init(gen, (d, f), cfg.dtype, device) for n in names}
    p["wd"] = dense_init(gen, (f, d), cfg.dtype, device,
                         scale=init_std_out(f, cfg.n_layers))
    return p


def mlp_apply(p, x, cfg: ModelConfig):
    x = _gathered(x)
    if cfg.act == "swiglu":
        return _block_out(ops.swiglu(x @ p["wg"], x @ p["wu"]) @ p["wd"],
                          cfg)
    return _block_out(ops.gelu(x @ p["wi"]) @ p["wd"], cfg)


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
    xf = ctx.constrain(x.reshape(G, TG, D), "dp", None, None)
    probs, counts, tok, valid, w_flat, xg = ops.on_shards(
        functools.partial(_moe_route, E=E, K=K, C=C), (xf, p["router"]),
        (0,), ({0: 0, 1: 1, 2: 2}, {}), [{0: 0}] * 6)
    xg = ctx.constrain(xg.reshape(G, E, C, D), "dp", "tp", None, None)
    xe = xg.transpose(0, 1).reshape(E, G * C, D)
    a = ops.swiglu(torch.bmm(xe, p["wg"]), torch.bmm(xe, p["wu"]))
    y = torch.bmm(a, p["wd"])                           # (E,G*C,D)
    y = y.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    # each rank adds its experts' outputs: a partial sum over the model
    # axis, reduced by the constraint (the expert-parallel combine)
    lead = {0: 0, 1: 1}
    out = ops.on_shards(
        functools.partial(_moe_combine, TG=TG, dtype=x.dtype),
        (y, w_flat, valid, tok), (0, 1), ({0: 0, 1: 1, 2: 2}, lead, lead,
                                          lead), {0: 0, 1: "sum"})
    out = ctx.constrain(out, "dp", None, None)
    # router aux loss (load balancing)
    me = probs.mean((0, 1))                             # (E,)
    ce = counts.sum(0).float() / (T * K)
    aux = E * torch.sum(me * ce)
    if mc.residual_ffn_dim:
        out = out + mlp_apply(p["res"], xf, cfg)
    return _block_out(out.reshape(B, S, D), cfg), aux


def _moe_route(xf, router, *, E: int, K: int, C: int):
    """Routing and dispatch of the token groups ``xf`` (G, TG, D): the
    router's probabilities, each group's expert counts, and per capacity
    slot (G, E*C) its token, whether it holds one, its combine weight,
    and the gathered inputs (G, E*C, D)."""
    G, TG, D = xf.shape
    dev = xf.device
    logits = xf.float() @ router                        # (G,TG,E)
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
    w_flat = torch.gather(wts.reshape(G, TG * K), 1, slot)
    return probs, counts, tok, valid, w_flat, xg


def _moe_combine(y, w_flat, valid, tok, *, TG: int, dtype):
    """Each token's weighted expert outputs ``y`` (G, E*C, D) added into
    (G, TG, D) with ``index_add_`` in the model dtype."""
    G, EC, D = y.shape
    y = y * (w_flat * valid)[..., None].to(y.dtype)
    out = torch.zeros((G * TG, D), dtype=dtype, device=y.device)
    garange = torch.arange(G, device=y.device)[:, None]
    out.index_add_(0, (tok + TG * garange).reshape(-1),
                   y.reshape(G * EC, D).to(dtype))
    return out.reshape(G, TG, D)


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
    z, xs, b, c, dt_raw = _mamba_proj(p, _gathered(x), cfg)
    if state is not None:
        w = min(sc.conv_width - 1, S)
        for name, u in (("conv_x", xs), ("conv_b", b), ("conv_c", c)):
            state[name][:, state[name].shape[1] - w:] = u[:, S - w:]
    xs = _silu(_causal_conv(xs, p["conv_x"]))
    b_mat = _silu(_causal_conv(b, p["conv_b"])).float()
    c_mat = _silu(_causal_conv(c, p["conv_c"])).float()
    # on DTensors in a local region: DTensor decomposes softplus
    dt = ops.on_shards(_dt_of, (dt_raw, p["dt_bias"]), range(3),
                       (ops.ident(dt_raw), {2: 0}), ops.ident(dt_raw))
    out = ops.ssd(xs.reshape(B, S, nh, sc.head_dim).float(), dt, p["a_log"],
                  b_mat, c_mat, p["d_skip"], chunk=sc.chunk,
                  return_state=state is not None)
    if state is not None:
        out, h_final = out
        state["h"].copy_(h_final)
    y = out.reshape(B, S, di).to(x.dtype)
    return _block_out(ops.rmsnorm_gated(y, z, p["norm_g"]) @ p["w_out"], cfg)


def _dt_of(dt_raw, dt_bias):
    """The SSD step sizes (B, S, nh): softplus of the projection plus the
    per-head bias, in f32."""
    return F.softplus(dt_raw.float() + dt_bias)                # (B,S,nh)


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
