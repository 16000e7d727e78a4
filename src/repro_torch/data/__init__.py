from .pipeline import DataConfig, ShardedTokenPipeline, synthetic_corpus

__all__ = ["DataConfig", "ShardedTokenPipeline", "synthetic_corpus"]
