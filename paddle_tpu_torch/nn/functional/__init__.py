from .attention import flash_attention, scaled_dot_product_attention
from .loss import cross_entropy

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "cross_entropy"]
