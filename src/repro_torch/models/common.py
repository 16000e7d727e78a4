"""Model configuration and shared utilities (device, RoPE, init, loading
the JAX package's parameters, the chunked cross-entropy loss)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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
    freqs = rope_freqs(head_dim, theta, positions.device)      # (hd/2,)
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


# -- init ------------------------------------------------------------------------
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
