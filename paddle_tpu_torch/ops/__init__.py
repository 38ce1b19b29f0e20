from . import ragged_paged_attention

__all__ = ["ragged_paged_attention"]
