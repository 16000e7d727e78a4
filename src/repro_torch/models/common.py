"""Model configuration and shared utilities (device, RoPE, init, loading
the JAX package's parameters)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


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
    torch dtype. The port serves the ``dense``, ``ssm``, ``hybrid`` and
    ``moe`` families (ROADMAP queue A for the others)."""
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
        the final norm."""
        d, v = self.d_model, self.vocab
        n = v * d if self.tie_embeddings else 2 * v * d
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        if self.family == "dense":
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


# -- init ------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal weights with std ``fan_in ** -0.5`` (or ``scale``), drawn in
    f32 and cast, as the JAX package's ``dense_init``. A torch generator
    gives other numbers than a JAX key of the same seed."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy's bfloat16 (ml_dtypes)
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_reference(np_params: Dict[str, Any], cfg: ModelConfig,
                          device) -> Dict[str, Any]:
    """The port's parameters from the JAX ``LM.init`` pytree given as
    numpy arrays (layer-stacked leading axis on ``layers``). Weights keep
    the ``x @ w`` layout; the layer stack becomes a list of per-layer
    dicts. The hybrid's ``shared`` block is one unstacked dict, used by
    every application, and passes through as it is. Dtypes are kept as
    given."""
    if cfg.family not in ("dense", "ssm", "hybrid", "moe"):
        raise NotImplementedError(f"family {cfg.family!r}")
    device = torch.device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _to_tensor(tree, device)

    out = {k: conv(v) for k, v in np_params.items() if k != "layers"}
    stacked = conv(np_params["layers"])

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i].contiguous()

    out["layers"] = [layer(stacked, i) for i in range(cfg.n_layers)]
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
