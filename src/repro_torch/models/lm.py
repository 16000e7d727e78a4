"""Decoder-only language models: the dense GQA, MoE, Mamba2 SSD, Zamba2
hybrid and Qwen2-VL (vlm) families.

The port of :mod:`repro.models.lm`. The API follows the JAX ``LM``:

  init(seed) -> params
  forward(params, tokens, positions3=None) -> (hidden, aux)
  logits(params, tokens, positions3=None)
  init_cache(batch, max_seq) -> cache
  prefill(params, tokens, positions3=None, max_seq=None) -> (logits, cache)
  decode_step(params, cache, token) -> (logits, cache)

``lax.scan`` over the stacked layers becomes a Python loop over a list of
per-layer parameter dicts; the hybrid's groups of ``shared_attn_every``
Mamba2 layers, each followed by the one shared attention+MLP block, are
a loop over the groups. The decode cache (the KV cache, the conv
histories and SSM states, or both for the hybrid) is updated in place.

The vlm family is the dense stack with M-RoPE: ``positions3`` (3, B, S)
gives each token its (t, h, w) position (the vision frontend is a stub in
both packages), and without it every axis takes the token's index (1-D
RoPE). Decode takes 1-D positions from ``cache["pos"]``, as the JAX
model does. The encoder-decoder family is :class:`repro_torch.models.
whisper.EncDecLM`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import layers as L
from .common import (ModelConfig, dense_init, mrope_cos_sin, resolve_device,
                     rope_cos_sin)

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


class LM:
    """Dense, MoE, Mamba2, hybrid or VLM decoder-only LM on one device."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in _FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} is not a decoder-only LM (encdec: "
                "repro_torch.models.whisper.EncDecLM, or get_model)")
        if cfg.family == "hybrid" and (
                cfg.shared_attn_every <= 0
                or cfg.n_layers % cfg.shared_attn_every):
            # the JAX model reshapes the layer stack into groups of k
            raise ValueError(f"hybrid: {cfg.n_layers} layers do not split "
                             f"into groups of {cfg.shared_attn_every}")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters ------------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters from a torch generator on the model's device,
        with the JAX init's distributions."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        params: Dict[str, Any] = {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype,
                                dev, scale=0.02),
            "final_norm": L.norm_init(cfg, dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                           cfg.dtype, dev)
        params["layers"] = [self._layer_init(gen)
                            for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            params["shared"] = self._shared_block_init(gen)
        return params

    def _layer_init(self, gen):
        cfg, dev = self.cfg, self.device
        if cfg.family in ("ssm", "hybrid"):
            return {"ln1": L.norm_init(cfg, dev),
                    "mamba": L.mamba_init(gen, cfg, dev)}
        if cfg.family == "moe":
            return {"ln1": L.norm_init(cfg, dev),
                    "attn": L.attn_init(gen, cfg, dev),
                    "ln2": L.norm_init(cfg, dev),
                    "moe": L.moe_init(gen, cfg, dev)}
        return self._shared_block_init(gen)

    def _shared_block_init(self, gen):
        """One attention+MLP block: a dense layer, or the hybrid's shared
        block."""
        cfg, dev = self.cfg, self.device
        return {"ln1": L.norm_init(cfg, dev), "attn": L.attn_init(gen, cfg, dev),
                "ln2": L.norm_init(cfg, dev), "mlp": L.mlp_init(gen, cfg, dev)}

    def _groups(self):
        """The hybrid's groups of layer indices, one per application of
        the shared block."""
        k = self.cfg.shared_attn_every
        return [range(i, i + k) for i in range(0, self.cfg.n_layers, k)]

    # -- rope ---------------------------------------------------------------------
    def _cos_sin(self, positions: torch.Tensor, batch_positions=None):
        """cos/sin (1, S, hd), or (B, S, hd) from vlm ``batch_positions``
        (3, B, S)."""
        cfg = self.cfg
        if cfg.family == "vlm":
            pos3 = batch_positions
            if pos3 is None:
                pos3 = positions[None, None, :].expand(3, 1, -1)
            return mrope_cos_sin(pos3, cfg.head_dim, cfg.rope_theta,
                                 cfg.mrope_sections)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        return cos[None], sin[None]       # (1, S, hd)

    def _check_positions3(self, positions3):
        """Every family but vlm refuses M-RoPE positions."""
        if positions3 is not None and self.cfg.family != "vlm":
            raise ValueError(f"positions3 is for the vlm family, not "
                             f"{self.cfg.family!r}")

    # -- forward (full sequence) ------------------------------------------------------
    def _mlp_or_moe(self, lp, h):
        """The feed-forward half of an attention layer: (output, aux)."""
        cfg = self.cfg
        xn = L.norm_apply(lp["ln2"], h, cfg)
        if cfg.family == "moe":
            return L.moe_apply(lp["moe"], xn, cfg)
        return L.mlp_apply(lp["mlp"], xn, cfg), None

    def _attn_block(self, lp, h, cos, sin):
        """Full-sequence attention layer (dense, moe, the hybrid's shared
        block): (h, aux)."""
        cfg = self.cfg
        h = h + L.attn_apply(lp["attn"], L.norm_apply(lp["ln1"], h, cfg),
                             cos, sin, cfg)
        y, aux = self._mlp_or_moe(lp, h)
        return h + y, aux

    def forward(self, params, tokens, positions3=None):
        """tokens (B, S) -> (final hidden (B, S, D), aux loss), aux the sum
        of the MoE layers' load-balancing losses (0 for the others)."""
        self._check_positions3(positions3)
        cfg = self.cfg
        h = params["embed"][tokens]
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.family == "ssm":
            for lp in params["layers"]:
                h = h + L.mamba_apply(lp["mamba"],
                                      L.norm_apply(lp["ln1"], h, cfg), cfg)
            return L.norm_apply(params["final_norm"], h, cfg), aux
        cos, sin = self._cos_sin(torch.arange(tokens.shape[1],
                                              device=h.device), positions3)
        if cfg.family == "hybrid":
            for group in self._groups():
                for i in group:
                    lp = params["layers"][i]
                    h = h + L.mamba_apply(
                        lp["mamba"], L.norm_apply(lp["ln1"], h, cfg), cfg)
                h, _ = self._attn_block(params["shared"], h, cos, sin)
            return L.norm_apply(params["final_norm"], h, cfg), aux
        for lp in params["layers"]:
            h, a = self._attn_block(lp, h, cos, sin)
            if a is not None:
                aux = aux + a
        return L.norm_apply(params["final_norm"], h, cfg), aux

    def _unembed(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    def logits(self, params, tokens, positions3=None):
        h, _ = self.forward(params, tokens, positions3)
        return h.float() @ self._unembed(params).float()

    # -- caches ------------------------------------------------------------------------
    def _cache_dtype(self):
        return torch.float8_e4m3fn if self.cfg.kv_cache_dtype == "f8" \
            else self.cfg.dtype

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        cfg = self.cfg
        cache: Dict[str, Any] = {"pos": 0}
        if cfg.family in ("ssm", "hybrid"):
            cache["ssm"] = L.mamba_init_state(cfg, cfg.n_layers, batch,
                                              cfg.dtype, self.device)
        if cfg.family == "ssm":
            return cache
        # one KV slot per attention layer, or per application of the
        # hybrid's shared block
        n_kv = cfg.n_layers // cfg.shared_attn_every \
            if cfg.family == "hybrid" else cfg.n_layers
        shape = (n_kv, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=self._cache_dtype(),
                                 device=self.device)
        cache["v"] = torch.zeros(shape, dtype=self._cache_dtype(),
                                 device=self.device)
        return cache

    def _layer_state(self, cache, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s views of the stacked ssm decode state."""
        return {k: v[i] for k, v in cache["ssm"].items()}

    # -- prefill ---------------------------------------------------------------------------
    def _attn_prefill(self, lp, h, cos, sin, cache, slot: int):
        """An attention layer's prefill; its k/v go to KV slot ``slot``."""
        cfg = self.cfg
        S = h.shape[1]
        a, (k, v) = L.attn_prefill(lp["attn"], L.norm_apply(lp["ln1"], h, cfg),
                                   cos, sin, cfg)
        h = h + a
        h = h + self._mlp_or_moe(lp, h)[0]
        cache["k"][slot, :, :, :S] = k
        cache["v"][slot, :, :, :S] = v
        return h

    def _mamba_prefill(self, lp, h, cache, i: int):
        cfg = self.cfg
        return h + L.mamba_apply(lp["mamba"], L.norm_apply(lp["ln1"], h, cfg),
                                 cfg, state=self._layer_state(cache, i))

    def prefill(self, params, tokens, positions3=None,
                max_seq: Optional[int] = None):
        """Full-sequence pass building a decode cache; returns last logits
        (B, 1, V). ``positions3`` (vlm): M-RoPE positions (3, B, S).
        ``max_seq`` reserves KV-cache room for decode growth (default
        S+256; the ssm state has a fixed size)."""
        self._check_positions3(positions3)
        cfg = self.cfg
        B, S = tokens.shape
        max_seq = max_seq or (S + 256)
        if max_seq < S:
            raise ValueError(f"max_seq {max_seq} < prompt length {S}")
        h = params["embed"][tokens]
        cache = self.init_cache(B, max_seq)
        cache["pos"] = S
        if cfg.family == "ssm":
            for i, lp in enumerate(params["layers"]):
                h = self._mamba_prefill(lp, h, cache, i)
        else:
            cos, sin = self._cos_sin(torch.arange(S, device=h.device),
                                     positions3)
            if cfg.family == "hybrid":
                for g, group in enumerate(self._groups()):
                    for i in group:
                        h = self._mamba_prefill(params["layers"][i], h,
                                                cache, i)
                    h = self._attn_prefill(params["shared"], h, cos, sin,
                                           cache, g)
            else:
                for i, lp in enumerate(params["layers"]):
                    h = self._attn_prefill(lp, h, cos, sin, cache, i)
        h = L.norm_apply(params["final_norm"], h, cfg)
        logits = h[:, -1:].float() @ self._unembed(params).float()
        return logits, cache

    # -- decode -------------------------------------------------------------------------------
    def _attn_decode(self, lp, h, cache, slot: int, pos: int, cos1, sin1):
        cfg = self.cfg
        a, _ = L.attn_decode(lp["attn"], L.norm_apply(lp["ln1"], h, cfg),
                             (cache["k"][slot], cache["v"][slot]), pos, cfg,
                             cos1, sin1)
        h = h + a
        return h + self._mlp_or_moe(lp, h)[0]

    def _mamba_decode(self, lp, h, cache, i: int):
        cfg = self.cfg
        y, _ = L.mamba_decode(lp["mamba"], L.norm_apply(lp["ln1"], h, cfg),
                              self._layer_state(cache, i), cfg)
        return h + y

    def decode_step(self, params, cache, token):
        """token (B, 1) int64; returns (logits (B,1,V), cache), the cache
        advanced in place."""
        cfg = self.cfg
        h = params["embed"][token]
        pos = cache["pos"]
        if cfg.family == "ssm":
            for i, lp in enumerate(params["layers"]):
                h = self._mamba_decode(lp, h, cache, i)
        else:
            cos1, sin1 = self._cos_sin(torch.tensor([pos], device=h.device))
            if cfg.family == "hybrid":
                for g, group in enumerate(self._groups()):
                    for i in group:
                        h = self._mamba_decode(params["layers"][i], h, cache,
                                               i)
                    h = self._attn_decode(params["shared"], h, cache, g, pos,
                                          cos1, sin1)
            else:
                for i, lp in enumerate(params["layers"]):
                    h = self._attn_decode(lp, h, cache, i, pos, cos1, sin1)
        cache["pos"] = pos + 1
        h = L.norm_apply(params["final_norm"], h, cfg)
        logits = h.float() @ self._unembed(params).float()
        return logits, cache
