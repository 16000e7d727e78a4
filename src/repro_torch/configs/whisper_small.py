"""Whisper-small [arXiv:2212.04356; unverified]. Enc-dec, conv frontend
STUB (precomputed frame embeddings): 12L enc + 12L dec, d_model=768,
12H MHA (kv=12), d_ff=3072, vocab=51865, head_dim=64, LayerNorm+GELU."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51_865, head_dim=64,
        norm="layernorm", act="gelu", n_enc_layers=12, max_seq=32_768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", family="encdec", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        head_dim=16, norm="layernorm", act="gelu", n_enc_layers=2,
        max_seq=256, remat=False, loss_chunk=32)
