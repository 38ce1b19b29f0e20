from .paged_cache import PageAllocator, PagedKVCache
from .sampling import GREEDY, SamplingParams
from .serving import AdmissionError, LlamaServingEngine, Request

__all__ = ["PageAllocator", "PagedKVCache", "GREEDY", "SamplingParams",
           "AdmissionError", "LlamaServingEngine", "Request"]
