"""Qwen2-VL-2B text backbone [arXiv:2409.12191; hf]. M-RoPE:
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, head_dim=128.
Vision patch frontend is a STUB, as in the JAX package (the caller
supplies 3-axis position ids); dynamic resolution reduces to the position
ids."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151_936, head_dim=128,
        norm="rmsnorm", act="swiglu", rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24), tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
        norm="rmsnorm", act="swiglu", mrope_sections=(2, 3, 3),
        tie_embeddings=True, remat=False, loss_chunk=32)
