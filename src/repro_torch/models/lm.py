"""Decoder-only language models: the dense GQA and Mamba2 SSD families.

The port of the dense and ssm families of :mod:`repro.models.lm`. The API
follows the JAX ``LM``:

  init(seed) -> params
  forward(params, tokens) / logits(params, tokens)
  init_cache(batch, max_seq) -> cache
  prefill(params, tokens) -> (logits, cache)
  decode_step(params, cache, token) -> (logits, cache)

``lax.scan`` over the stacked layers becomes a Python loop over a list of
per-layer parameter dicts. The decode cache (the KV cache, or the conv
histories and SSM states) is updated in place. The other families (moe,
hybrid, vlm, encdec) raise ``NotImplementedError``: they are item 11 of
ROADMAP queue A.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import layers as L
from .common import ModelConfig, dense_init, resolve_device, rope_cos_sin

_PORTED = ("dense", "ssm")
_NOT_PORTED = {
    "moe": "ROADMAP queue A item 11 (the other families: MoE)",
    "hybrid": "ROADMAP queue A item 11 (the other families: zamba2)",
    "vlm": "ROADMAP queue A item 11 (the other families: VLM)",
    "encdec": "ROADMAP queue A item 11 (the other families: whisper)",
}


class LM:
    """Dense or Mamba2 decoder-only LM on one device."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in _PORTED:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet: "
                f"{_NOT_PORTED.get(cfg.family, 'ROADMAP queue A')}")
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
        return params

    def _layer_init(self, gen):
        cfg, dev = self.cfg, self.device
        if cfg.family == "ssm":
            return {"ln1": L.norm_init(cfg, dev),
                    "mamba": L.mamba_init(gen, cfg, dev)}
        return {"ln1": L.norm_init(cfg, dev), "attn": L.attn_init(gen, cfg, dev),
                "ln2": L.norm_init(cfg, dev), "mlp": L.mlp_init(gen, cfg, dev)}

    # -- rope ---------------------------------------------------------------------
    def _cos_sin(self, positions: torch.Tensor):
        cfg = self.cfg
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        return cos[None], sin[None]       # (1, S, hd)

    # -- forward (full sequence) ------------------------------------------------------
    def forward(self, params, tokens):
        """tokens (B, S) -> final hidden (B, S, D)."""
        cfg = self.cfg
        h = params["embed"][tokens]
        if cfg.family == "ssm":
            for lp in params["layers"]:
                h = h + L.mamba_apply(lp["mamba"],
                                      L.norm_apply(lp["ln1"], h, cfg), cfg)
            return L.norm_apply(params["final_norm"], h, cfg)
        cos, sin = self._cos_sin(torch.arange(tokens.shape[1],
                                              device=h.device))
        for lp in params["layers"]:
            h = h + L.attn_apply(lp["attn"], L.norm_apply(lp["ln1"], h, cfg),
                                 cos, sin, cfg)
            h = h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln2"], h, cfg),
                                cfg)
        return L.norm_apply(params["final_norm"], h, cfg)

    def _unembed(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    def logits(self, params, tokens):
        h = self.forward(params, tokens)
        return h.float() @ self._unembed(params).float()

    # -- caches ------------------------------------------------------------------------
    def _cache_dtype(self):
        return torch.float8_e4m3fn if self.cfg.kv_cache_dtype == "f8" \
            else self.cfg.dtype

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"pos": 0,
                    "ssm": L.mamba_init_state(cfg, cfg.n_layers, batch,
                                              cfg.dtype, self.device)}
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {"pos": 0,
                "k": torch.zeros(shape, dtype=self._cache_dtype(),
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self._cache_dtype(),
                                 device=self.device)}

    def _layer_state(self, cache, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s views of the stacked ssm decode state."""
        return {k: v[i] for k, v in cache["ssm"].items()}

    # -- prefill ---------------------------------------------------------------------------
    def prefill(self, params, tokens, max_seq: Optional[int] = None):
        """Full-sequence pass building a decode cache; returns last logits
        (B, 1, V). ``max_seq`` reserves KV-cache room for decode growth
        (default S+256; the ssm state has a fixed size)."""
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
                h = h + L.mamba_apply(lp["mamba"],
                                      L.norm_apply(lp["ln1"], h, cfg), cfg,
                                      state=self._layer_state(cache, i))
        else:
            cos, sin = self._cos_sin(torch.arange(S, device=h.device))
            for i, lp in enumerate(params["layers"]):
                xn = L.norm_apply(lp["ln1"], h, cfg)
                a, (k, v) = L.attn_prefill(lp["attn"], xn, cos, sin, cfg)
                h = h + a
                h = h + L.mlp_apply(lp["mlp"],
                                    L.norm_apply(lp["ln2"], h, cfg), cfg)
                cache["k"][i, :, :, :S] = k
                cache["v"][i, :, :, :S] = v
        h = L.norm_apply(params["final_norm"], h, cfg)
        logits = h[:, -1:].float() @ self._unembed(params).float()
        return logits, cache

    # -- decode -------------------------------------------------------------------------------
    def decode_step(self, params, cache, token):
        """token (B, 1) int64; returns (logits (B,1,V), cache), the cache
        advanced in place."""
        cfg = self.cfg
        h = params["embed"][token]
        pos = cache["pos"]
        if cfg.family == "ssm":
            for i, lp in enumerate(params["layers"]):
                y, _ = L.mamba_decode(lp["mamba"],
                                      L.norm_apply(lp["ln1"], h, cfg),
                                      self._layer_state(cache, i), cfg)
                h = h + y
        else:
            cos1, sin1 = self._cos_sin(torch.tensor([pos], device=h.device))
            for i, lp in enumerate(params["layers"]):
                xn = L.norm_apply(lp["ln1"], h, cfg)
                a, _ = L.attn_decode(lp["attn"], xn,
                                     (cache["k"][i], cache["v"][i]), pos,
                                     cfg, cos1, sin1)
                h = h + a
                h = h + L.mlp_apply(lp["mlp"],
                                    L.norm_apply(lp["ln2"], h, cfg), cfg)
        cache["pos"] = pos + 1
        h = L.norm_apply(params["final_norm"], h, cfg)
        logits = h.float() @ self._unembed(params).float()
        return logits, cache
