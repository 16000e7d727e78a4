"""Whisper-style encoder-decoder backbone (the encdec family).

The port of :mod:`repro.models.whisper`. As there, the conv/mel frontend
is a stub: the encoder takes precomputed frame embeddings
(B, S_enc, d_model). LayerNorm + GELU + MHA with no RoPE: sinusoidal
encoder positions, learned decoder positions, the output tied to the
token embedding. The API:

  init(seed) -> params
  encode(params, frames) -> enc_out
  forward(params, tokens, enc_out) -> final hidden
  loss(params, batch) -> mean masked next-token cross-entropy
  init_cache(batch, max_seq, enc_len) -> cache
  prefill(params, tokens, frames=None, max_seq=None) -> (logits, cache)
  decode_step(params, cache, token) -> (logits, cache)

``lax.scan`` over the stacked layers becomes a Python loop over lists of
per-layer dicts; under autograd with ``cfg.remat`` each encoder and
decoder layer is rematerialised, as ``jax.checkpoint`` wraps the scan
bodies (the encoder output is an input of every checkpointed decoder
layer, so its gradient sums over them). The encoder's self-attention and the decoder's
cross-attention run the flash kernel non-causal, the decoder's
self-attention causal. The kernel takes k/v of q's length, so the
encoder output has the prompt's length on every path, as the JAX server
gives it (frames shaped like the prompt). Prefill keeps each layer's
cross-attention k/v (``xk``/``xv``, from the encoder output once); a
decode tick attends over them with :func:`ops.attention_decode`. The
cache is updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.parallel import ctx
from . import layers as L
from .common import (ModelConfig, chunked_softmax_xent, dense_init,
                     embed_lookup, init_generator, place_cache, remat_layer,
                     resolve_device)


def sinusoidal_pos(S: int, d: int, dtype=torch.float32, device=None):
    """(S, d) sinusoidal positions: sin on even columns, cos on odd."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (dim / d))
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)


class EncDecLM:
    """Whisper's encoder-decoder on one device."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM serves the encdec family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- init ----------------------------------------------------------------
    def _enc_layer_init(self, gen):
        cfg, dev = self.cfg, self.device
        return {"ln1": L.norm_init(cfg, dev), "attn": L.attn_init(gen, cfg, dev),
                "ln2": L.norm_init(cfg, dev), "mlp": L.mlp_init(gen, cfg, dev)}

    def _dec_layer_init(self, gen):
        cfg, dev = self.cfg, self.device
        return {"ln1": L.norm_init(cfg, dev),
                "self_attn": L.attn_init(gen, cfg, dev),
                "ln2": L.norm_init(cfg, dev),
                "cross_attn": L.attn_init(gen, cfg, dev),
                "ln3": L.norm_init(cfg, dev), "mlp": L.mlp_init(gen, cfg, dev)}

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters from a torch generator on the model's device,
        with the JAX init's distributions."""
        cfg, dev = self.cfg, self.device
        gen = init_generator(dev, seed)
        return {
            "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.dtype,
                                dev, scale=0.02),
            "dec_pos": dense_init(gen, (cfg.max_seq, cfg.d_model), cfg.dtype,
                                  dev, scale=0.02),
            "enc_layers": [self._enc_layer_init(gen)
                           for _ in range(cfg.n_enc_layers)],
            "dec_layers": [self._dec_layer_init(gen)
                           for _ in range(cfg.n_layers)],
            "enc_norm": L.norm_init(cfg, dev),
            "final_norm": L.norm_init(cfg, dev),
        }

    def _unembed(self, params):
        return params["embed"].T  # whisper ties output to token embedding

    # -- encoder -----------------------------------------------------------------
    def _enc_block(self, lp, h):
        cfg = self.cfg
        h = h + L.attn_apply(lp["attn"], L.norm_apply(lp["ln1"], h, cfg),
                             None, None, cfg, causal=False)
        return h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln2"], h, cfg),
                               cfg)

    def encode(self, params, frames):
        """frames: (B, S_enc, d_model) precomputed embeddings (stub)."""
        cfg = self.cfg
        S = frames.shape[1]
        h = frames.to(cfg.dtype) + ctx.like(frames, sinusoidal_pos(
            S, cfg.d_model, cfg.dtype, frames.device))
        h = ctx.constrain(h, "dp", None, None)
        for lp in params["enc_layers"]:
            h = self._out(remat_layer(cfg, self._enc_block, lp, h))
        return L.norm_apply(params["enc_norm"], h, cfg)

    def _out(self, h):
        """A layer's output constrained as the reference's scan bodies."""
        return ctx.constrain(h, "dp", "tp" if self.cfg.seq_shard else None,
                             None)

    # -- decoder (full sequence) ------------------------------------------------------
    def _embed(self, params, tokens, pos: int = 0):
        """Token embeddings plus the learned positions from ``pos`` on."""
        S = tokens.shape[1]
        n_pos = params["dec_pos"].shape[0]
        if pos + S > n_pos:
            raise ValueError(f"positions {pos}..{pos + S - 1} are past the "
                             f"{n_pos} learned decoder positions")
        return (embed_lookup(params["embed"], tokens)
                + params["dec_pos"][pos:pos + S][None])

    def _dec_block(self, lp, h, enc_out):
        cfg = self.cfg
        h = h + L.attn_apply(lp["self_attn"], L.norm_apply(lp["ln1"], h, cfg),
                             None, None, cfg, causal=True)
        h = h + L.attn_apply(lp["cross_attn"],
                             L.norm_apply(lp["ln2"], h, cfg),
                             None, None, cfg, kv_x=enc_out)
        return h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln3"], h, cfg),
                               cfg)

    def forward(self, params, tokens, enc_out):
        """tokens (B, S) over encoder states (B, S_enc, D) -> final hidden
        (B, S, D)."""
        cfg = self.cfg
        h = ctx.constrain(self._embed(params, tokens), "dp", None, None)
        for lp in params["dec_layers"]:
            h = self._out(remat_layer(cfg, self._dec_block, lp, h, enc_out))
        return L.norm_apply(params["final_norm"], h, cfg)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean masked next-token cross-entropy of the decoder over the
        encoded frames, as the JAX ``EncDecLM.loss``. ``batch``: frames
        (B, S_enc, d_model), tokens and labels (B, S) int64, optional mask
        (B, S), on the model's device."""
        labels = batch["labels"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        enc_out = self.encode(params, batch["frames"])
        h = self.forward(params, batch["tokens"], enc_out)
        return chunked_softmax_xent(h, self._unembed(params), labels, mask,
                                    chunk=self.cfg.loss_chunk)

    # -- serving ------------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   enc_len: int) -> Dict[str, Any]:
        """Self-attention k/v of ``max_seq`` positions and cross-attention
        k/v of ``enc_len`` encoder positions, one slot per decoder
        layer."""
        cfg = self.cfg

        def zeros(S):
            return torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, S,
                                cfg.head_dim), dtype=cfg.dtype,
                               device=self.device)

        return {"pos": 0, "k": zeros(max_seq), "v": zeros(max_seq),
                "xk": zeros(enc_len), "xv": zeros(enc_len)}

    def prefill(self, params, tokens, frames=None,
                max_seq: Optional[int] = None):
        """Encode, then run the decoder over the prompt, building the
        caches; returns last logits (B, 1, V). The audio frontend is a
        stub: ``frames`` default to zeros of the prompt's length, as the
        JAX model's (and as its server passes them)."""
        cfg = self.cfg
        B, S = tokens.shape
        max_seq = max_seq or (S + 256)
        if max_seq < S:
            raise ValueError(f"max_seq {max_seq} < prompt length {S}")
        if frames is None:
            frames = torch.zeros((B, S, cfg.d_model), dtype=cfg.dtype,
                                 device=tokens.device)
        enc_out = self.encode(params, frames)
        cache = place_cache(cfg, self.init_cache(B, max_seq,
                                                 enc_out.shape[1]),
                            params["embed"])
        cache["pos"] = S
        h = self._embed(params, tokens)
        for i, lp in enumerate(params["dec_layers"]):
            xn = L.norm_apply(lp["ln1"], h, cfg)
            a, (k, v) = L.attn_prefill(lp["self_attn"], xn, None, None, cfg)
            h = h + a
            L.write_prefix(cache["k"], i, k)
            L.write_prefix(cache["v"], i, v)
            # cross-attention k/v, projected once: kept for decode and
            # attended over here
            xp = lp["cross_attn"]
            xk = L._split_heads(enc_out @ xp["wk"], cfg.n_kv_heads,
                                cfg.head_dim)
            xv = L._split_heads(enc_out @ xp["wv"], cfg.n_kv_heads,
                                cfg.head_dim)
            L.write_prefix(cache["xk"], i, xk)
            L.write_prefix(cache["xv"], i, xv)
            q = L._split_heads(L.norm_apply(lp["ln2"], h, cfg) @ xp["wq"],
                               cfg.n_heads, cfg.head_dim)
            o = ops.attention(q, xk, xv, causal=False)
            h = h + L._merge_heads(o) @ xp["wo"]
            h = h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln3"], h, cfg),
                                cfg)
        h = L.norm_apply(params["final_norm"], h, cfg)
        logits = h[:, -1:].float() @ self._unembed(params).float()
        return logits, cache

    def decode_step(self, params, cache, token):
        """token (B, 1) int64; returns (logits (B,1,V), cache), the cache
        advanced in place."""
        cfg = self.cfg
        pos = cache["pos"]
        h = self._embed(params, token, pos)
        for i, lp in enumerate(params["dec_layers"]):
            xn = L.norm_apply(lp["ln1"], h, cfg)
            a, _ = L.attn_decode(lp["self_attn"], xn,
                                 (cache["k"][i], cache["v"][i]), pos, cfg)
            h = h + a
            xn2 = L.norm_apply(lp["ln2"], h, cfg)
            q = L._split_heads(xn2 @ lp["cross_attn"]["wq"], cfg.n_heads,
                               cfg.head_dim)
            o = ops.attention_decode(q, cache["xk"][i], cache["xv"][i])
            h = h + L._merge_heads(o) @ lp["cross_attn"]["wo"]
            h = h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln3"], h, cfg),
                                cfg)
        cache["pos"] = pos + 1
        h = L.norm_apply(params["final_norm"], h, cfg)
        logits = h.float() @ self._unembed(params).float()
        return logits, cache
