from .token_feed import DevicePrefetcher

__all__ = ["DevicePrefetcher"]
