from .embedding_cache import EmbeddingCache
from .engine import InferenceEngine

__all__ = ['EmbeddingCache', 'InferenceEngine']
