from .token_feed import DevicePrefetcher, PyTokenFeed, TokenFeed

__all__ = ["TokenFeed", "PyTokenFeed", "DevicePrefetcher"]
