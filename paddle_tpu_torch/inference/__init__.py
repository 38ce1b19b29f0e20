from .paged_cache import PageAllocator, PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import GREEDY, SamplingParams
from .serving import (AdmissionError, DeadlineExceeded, LlamaServingEngine,
                      Request)

__all__ = ["PageAllocator", "PagedKVCache", "PrefixCache", "GREEDY",
           "SamplingParams", "AdmissionError", "DeadlineExceeded",
           "LlamaServingEngine", "Request"]
