from .llm_engine import GenerationResult, LLMEngine, calibrate_kv_scales
from .paged_cache import BlockAllocator, PagedKVCache
# speculative decoding: draft proposers and the config of
# LLMEngine(speculative_config=...)
from .speculative import (DraftModelProposer, DraftProposer, NgramProposer,
                          SpeculativeConfig)

__all__ = ["BlockAllocator", "DraftModelProposer", "DraftProposer",
           "GenerationResult", "LLMEngine", "NgramProposer", "PagedKVCache",
           "SpeculativeConfig", "calibrate_kv_scales"]
