from .paged_cache import PageAllocator, PagedKVCache
from .serving import AdmissionError, LlamaServingEngine, Request

__all__ = ["PageAllocator", "PagedKVCache", "AdmissionError",
           "LlamaServingEngine", "Request"]
