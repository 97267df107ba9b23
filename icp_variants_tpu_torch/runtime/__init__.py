"""Host runtime: the native IO library and the batch prefetcher."""
