from .paged_cache import PageAllocator
from .serving import AdmissionError, LlamaServingEngine, Request

__all__ = ["PageAllocator", "AdmissionError", "LlamaServingEngine",
           "Request"]
