"""Device-memory management: the KV page allocator and pool ops."""
