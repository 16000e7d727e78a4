"""Model configuration and shared utilities (device, RoPE, init, loading
the JAX package's parameters, the chunked cross-entropy loss)."""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import ctx


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Expert geometry, as :class:`repro.models.common.MoEConfig`."""
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Arctic-style dense residual MLP running in parallel with the experts
    residual_ffn_dim: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 block geometry, as :class:`repro.models.common.SSMConfig`."""
    state_dim: int = 128        # N
    head_dim: int = 64          # P
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of :class:`repro.models.common.ModelConfig`, with a
    torch dtype. The port serves all six families."""
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared* attention+MLP block applied every k SSM
    # blocks (parameter tying)
    shared_attn_every: int = 0
    n_enc_layers: int = 0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    seq_shard: bool = False
    loss_chunk: int = 512
    # decode KV-cache storage dtype: "bf16" (default) or "f8" (e4m3)
    kv_cache_dtype: str = "bf16"
    max_seq: int = 131_072
    sub_quadratic: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings, layers, the hybrid's
        shared block and the final norm): the JAX package's count plus
        the final norm; for encdec, every parameter the model holds (the
        JAX count leaves out the learned decoder positions, the LayerNorm
        biases and final norms, and counts an unembedding that whisper's
        tied output does not have)."""
        d, v = self.d_model, self.vocab
        n = v * d if self.tie_embeddings else 2 * v * d
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        if self.family == "encdec":
            norm = 2 * d if self.norm == "layernorm" else d
            return (v * d + self.max_seq * d
                    + self.n_layers * (2 * attn + mlp + 3 * norm)
                    + self.n_enc_layers * (attn + mlp + 2 * norm) + 2 * norm)
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn + mlp + 2 * d)
        elif self.family == "moe":
            mc = self.moe
            experts = mc.n_experts * 3 * d * self.d_ff + d * mc.n_experts
            res = 3 * d * mc.residual_ffn_dim
            n += self.n_layers * (attn + experts + res + 2 * d)
        elif self.family in ("ssm", "hybrid"):
            n += self.n_layers * (self._ssm_block_params() + d)
            if self.family == "hybrid":
                n += attn + mlp + 2 * d          # one shared block
        else:
            raise NotImplementedError(f"family {self.family!r}")
        return n + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only), in the JAX
        package's count, which :func:`model_flops_for` reads: for every
        family but encdec :meth:`param_count` without the final norm, for
        encdec the JAX count (see :meth:`param_count`)."""
        d = self.d_model
        if self.family == "encdec":
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            mlp = (3 if self.act == "swiglu" else 2) * d * self.d_ff
            n = (1 if self.tie_embeddings else 2) * self.vocab * d
            return (n + self.n_layers * (2 * attn + mlp + 3 * d)
                    + self.n_enc_layers * (attn + mlp + 2 * d))
        n = self.param_count() - d
        if self.family == "moe":
            e, k = self.moe.n_experts, self.moe.top_k
            n -= self.n_layers * (e - k) * 3 * d * self.d_ff
        return n

    def _ssm_block_params(self) -> int:
        sc, d = self.ssm, self.d_model
        di, nh, ns = sc.d_inner(d), sc.n_heads(d), sc.state_dim
        # in_proj: z, x, B, C, dt; out_proj; conv; A, D, dt_bias; norm
        return (d * (2 * di + 2 * ns + nh) + di * d
                + sc.conv_width * (di + 2 * ns) + 3 * nh + di)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no CUDA device and no explicit device it raises — the
    port never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


# -- RoPE -----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim) in rotate-half layout."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs      # (..., hd/2)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]):
    """Qwen2-VL M-RoPE. positions (3, B, S) for (t, h, w); sections sum to
    head_dim/2. Frequency slice ``i`` takes its angle from axis ``i``'s
    positions. Text tokens use identical t/h/w positions (1-D RoPE);
    vision patches get distinct h/w. Returns cos/sin (B, S, head_dim) in
    rotate-half layout."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {head_dim // 2}")
    freqs = ctx.like(positions, rope_freqs(head_dim, theta,
                                           positions.device))  # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * freqs       # (3,B,S,hd/2)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, ..., start:start + sec])
        start += sec
    ang1 = torch.cat(parts, dim=-1)                            # (B,S,hd/2)
    ang2 = torch.cat([ang1, ang1], dim=-1)
    return torch.cos(ang2), torch.sin(ang2)


# -- loss ------------------------------------------------------------------------
def _chunk_nll(h, unembed, labels, mask, vocab: int):
    """Summed masked NLL of one chunk: f32 logits over the padded vocab,
    the padding masked to -1e30."""
    logits = h.float() @ unembed
    if unembed.shape[-1] != vocab:
        col = torch.arange(unembed.shape[-1], device=logits.device)
        logits = torch.where(col < vocab, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def remat_layer(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, one layer, rematerialised in the backward under
    autograd with ``cfg.remat`` (a layer has no randomness, so no RNG
    state is kept); a plain call otherwise, and always under ``no_grad``
    (serving checkpoints nothing)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def chunked_softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materializing the (B, S, V) logits: the port
    of :func:`repro.models.common.chunked_softmax_xent`.

    The sequence runs in chunks (``chunk``, or ``gcd(S, chunk)`` where it
    does not divide S); each chunk's (B, chunk, V) f32 logits live only
    inside a ``torch.utils.checkpoint`` region, so the backward recomputes
    them instead of keeping every chunk's softmax. The vocab is padded to
    a multiple of 2048 (the JAX package pads it so the logits' V axis
    shards evenly), the padded columns masked to -1e30. The unembedding is
    cast to f32 (and padded) once per call, not once per chunk: the same
    arithmetic, without a (D, V) f32 copy per chunk (at minitron's
    256,000 x 3072, 3.1 GB each).
    hidden: (B, S, D) f32/bf16; unembed: (D, V); labels/mask: (B, S)."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = math.gcd(S, chunk) or S
    if ctx.is_dtensor(hidden):
        return _sharded_xent(hidden, unembed, labels, mask, chunk)
    V = unembed.shape[-1]
    Vp = (V + 2047) // 2048 * 2048
    w = unembed.float()
    if Vp != V:
        w = F.pad(w, (0, Vp - V))
    mask = mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        args = (hidden[:, sl], w, labels[:, sl], mask[:, sl], V)
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_nll, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            tot = tot + _chunk_nll(*args)
    return tot / torch.clamp(mask.sum(), min=1.0)


def _reduce_sum(x, group):
    """``x`` summed over ``group``'s ranks (a functional all-reduce); its
    gradient passes through as it is: every rank's loss reads the same
    sum, so each rank's part takes the sum's gradient unchanged."""
    return _SumOverRanks.apply(x, group)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx_, g):
        return g, None


def _vocab_parallel_nll(h, w, labels, mask, group):
    """One chunk's summed masked NLL on this rank's shards: rows of the
    batch and a slice of the vocabulary (``w``, f32, ``group``'s rank
    ``r`` holding columns ``r * V_r`` on). The max, the sum of
    exponentials and the gold logit are reduced over ``group``, as GSPMD
    reduces the reference's logits sharded over the model axis; the
    vocabulary's padding is not built (its columns add exp(-1e30) = 0)."""
    from torch.distributed import _functional_collectives as funcol
    logits = h.float() @ w
    Vr = w.shape[-1]
    v0 = torch.distributed.get_rank(group) * Vr
    m = funcol.wait_tensor(funcol.all_reduce(
        torch.amax(logits, dim=-1).detach(), "max", group))
    se = _reduce_sum(torch.exp(logits - m[..., None]).sum(-1), group)
    logz = m + torch.log(se)
    local = labels - v0
    mine = (local >= 0) & (local < Vr)
    gold = torch.gather(logits, -1, local.clamp(0, Vr - 1)[..., None])[..., 0]
    gold = _reduce_sum(torch.where(mine, gold, 0.0), group)
    return ((logz - gold) * mask).sum()


def _sharded_xent(hidden, unembed, labels, mask, chunk: int):
    """:func:`chunked_softmax_xent` of DTensors under the active mesh: the
    hidden state's rows over the data axes, the f32 unembedding's
    vocabulary over the model axis where it divides (else replicated),
    each chunk's NLL in a ``local_map`` region. On a model axis of one
    rank, or with the vocabulary replicated, the region computes each
    chunk as the one-device loss does, padding included."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = hidden.device_mesh
    B, S, D = hidden.shape
    V = unembed.shape[-1]
    hidden = ctx.constrain(hidden, "dp", None, None)
    labels = ctx.constrain(ctx.replicated(labels, mesh), "dp", None)
    mask = ctx.constrain(ctx.replicated(mask.float(), mesh), "dp", None)
    w = ctx.constrain(unembed.float(), None, "tp")
    names = list(mesh.mesh_dim_names)
    tp = names.index("model") if "model" in names else None
    v_sharded = tp is not None and w.placements[tp].is_shard() \
        and mesh.size(tp) > 1
    if v_sharded:
        group = mesh.get_group(tp)
        nll = functools.partial(_vocab_parallel_nll, group=group)
    else:
        # the vocabulary whole on every model rank: padded once, as the
        # one-device loss pads it
        w = ctx.constrain(w, None, None)
        Vp = (V + 2047) // 2048 * 2048
        if Vp != V:
            w = F.pad(w, (0, Vp - V))
        nll = functools.partial(_chunk_nll, vocab=V)
    rows = tuple(p if p.is_shard() else Replicate() for p in hidden.placements)
    out_pl = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    h_grad = tuple(Partial() if i == tp and v_sharded else p
                   for i, p in enumerate(rows))
    w_pl = tuple(w.placements)
    w_grad = tuple(Partial() if p.is_shard() else q
                   for p, q in zip(rows, w_pl))
    region = local_map(
        nll, out_placements=(out_pl,),
        in_placements=(rows, w_pl, rows, rows),
        in_grad_placements=(h_grad, w_grad, rows, rows), device_mesh=mesh)
    # the chunks' Partial sums are added to a Partial zero and reduced
    # once: a plain zero would leave it to DTensor's propagation (which
    # differs between torch versions) whether each chunk is reduced on
    # its own
    tot = DTensor.from_local(torch.zeros((), dtype=torch.float32,
                                         device=hidden.device),
                             mesh, out_pl, run_check=False)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        args = (hidden[:, sl], w, labels[:, sl], mask[:, sl])
        tot = tot + (checkpoint(region, *args, use_reentrant=False,
                                preserve_rng_state=False)
                     if torch.is_grad_enabled() else region(*args))
    rep = [Replicate()] * mesh.ndim
    return tot.redistribute(mesh, rep) / torch.clamp(
        mask.sum().redistribute(mesh, rep), min=1.0)


def place_cache(cfg, cache, like):
    """A decode cache placed as the reference's ``cache_specs`` place it
    on the active mesh when ``like`` (a parameter) is a DTensor; as it is
    otherwise."""
    if not ctx.is_dtensor(like):
        return cache
    from repro_torch.parallel.sharding import cache_specs, distribute
    mesh = ctx.active_mesh()
    return distribute(cache, cache_specs(cfg, cache, mesh), mesh)


def embed_lookup(table, tokens):
    """The rows of ``table`` for ``tokens``: ``table[tokens]``. A DTensor
    table is looked up vocab-parallel, as GSPMD would shard the
    reference's gather of a table sharded (model, fsdp): a
    ``local_map`` region with the table's rows over the model axis and
    its columns gathered over the data axes (FSDP's gather), the tokens
    over the data axes; each model rank fills the rows of the tokens its
    slice of the vocabulary holds and zeros elsewhere, a ``Partial`` sum
    over the model axis that the caller's constraint reduces. A table
    whose vocabulary is not sharded is looked up whole on each rank."""
    if not ctx.is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = ctx.replicated(tokens, mesh)
    names = list(mesh.mesh_dim_names)
    tp = names.index("model") if "model" in names else None
    split = tp is not None and table.placements[tp].is_shard() \
        and table.placements[tp].dim == 0 and mesh.size(tp) > 1
    t_pl = tuple(Shard(0) if split and i == tp else Replicate()
                 for i in range(mesh.ndim))
    x_pl = tuple(p if p.is_shard() and p.dim == 0 and i != tp
                 else Replicate() for i, p in enumerate(tokens.placements))
    out_pl = tuple(Partial() if split and i == tp else p
                   for i, p in enumerate(x_pl))
    g_pl = tuple(Partial() if p.is_shard() else q
                 for p, q in zip(x_pl, t_pl))

    def lookup(table, tokens):
        if not split:
            return table[tokens]
        Vr = table.shape[0]
        local = tokens - mesh.get_local_rank(tp) * Vr
        mine = (local >= 0) & (local < Vr)
        rows = table[local.clamp(0, Vr - 1)]
        return rows * mine[..., None].to(rows.dtype)
    return local_map(lookup, out_placements=(out_pl,),
                     in_placements=(t_pl, x_pl),
                     in_grad_placements=(g_pl, x_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


# -- init ------------------------------------------------------------------------
def init_generator(device, seed: int) -> torch.Generator:
    """The torch generator an init draws from on ``device``, seeded. A
    ``meta`` device has no generator of its own: its draws take a CPU
    generator, which gives them shapes and dtypes and no numbers (the
    dry run's parameters)."""
    device = torch.device(device)
    return torch.Generator(device="cpu" if device.type == "meta"
                           else device).manual_seed(seed)


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights with std ``fan_in ** -0.5`` (or ``scale``), drawn in
    f32 and cast, as the JAX package's ``dense_init``. A torch generator
    gives other numbers than a JAX key of the same seed. The draw is scaled
    in place: one f32 temporary (arctic-480b's (128, 7168, 4864) expert
    weight is 17.8 GB in f32)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy's bfloat16 (ml_dtypes)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def reference_stacks(cfg: ModelConfig) -> Dict[str, int]:
    """The parameter tree's layer stacks and their depths: the subtrees
    the JAX package stacks along a leading layer axis and the port keeps
    as lists of per-layer dicts."""
    return {"encdec": {"enc_layers": cfg.n_enc_layers,
                       "dec_layers": cfg.n_layers}}.get(
        cfg.family, {"layers": cfg.n_layers})


def reference_ndim(cfg: ModelConfig, path, p: torch.Tensor) -> int:
    """``p``'s ``ndim`` in the JAX package's stacked layout: one more
    under a layer stack (the hybrid's unstacked ``shared`` block and the
    final norm keep their own)."""
    return p.ndim + (1 if path and path[0] in reference_stacks(cfg) else 0)


def params_from_reference(np_params: Dict[str, Any], cfg: ModelConfig,
                          device) -> Dict[str, Any]:
    """The port's parameters from the JAX ``LM.init`` (or, for encdec,
    ``EncDecLM.init``) pytree given as numpy arrays, each layer stack
    (``layers``; ``enc_layers`` and ``dec_layers``) with a leading layer
    axis. Weights keep the ``x @ w`` layout; each stack becomes a list of
    per-layer dicts. The hybrid's ``shared`` block is one unstacked dict,
    used by every application, and passes through as it is, as do
    whisper's ``dec_pos`` and its norms. Dtypes are kept as given."""
    stacks = reference_stacks(cfg)
    device = torch.device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _to_tensor(tree, device)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i].contiguous()

    out = {k: conv(v) for k, v in np_params.items() if k not in stacks}
    for name, n in stacks.items():
        stacked = conv(np_params[name])
        out[name] = [layer(stacked, i) for i in range(n)]
    return out


def tree_bytes(tree) -> int:
    """Bytes held by the tensors of a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def init_std_out(fan_in: int, n_layers: int) -> float:
    """Std of a residual-branch output projection: ``fan_in ** -0.5``
    scaled by ``1/sqrt(2 L)``, as the JAX package's attention and MLP
    init."""
    return (fan_in ** -0.5) / math.sqrt(2 * n_layers)
