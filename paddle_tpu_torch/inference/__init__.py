from .llm_engine import GenerationResult, LLMEngine
from .paged_cache import BlockAllocator, PagedKVCache

__all__ = ["BlockAllocator", "GenerationResult", "LLMEngine",
           "PagedKVCache"]
