"""Device-memory management: the paged KV allocator and host tiering.

`page_allocator` hands out refcounted integer page ids against a fixed
device pool, with the pool ops that pair with it. `migration` layers a
host-RAM tier on top: a two-tier allocator with per-page residency, a
pinned host arena and an async page-migration engine on its own CUDA
stream, turning the device pool into a cache over a larger page store.
"""
from .migration import (HostPageStore, MigrationEngine, MigrationTicket,
                        Residency, TieredPageAllocator)
from .page_allocator import (PageAllocator, PageExhausted, copy_page,
                             gather_pages, write_pages)

__all__ = ["PageAllocator", "PageExhausted", "copy_page", "write_pages",
           "gather_pages", "Residency", "TieredPageAllocator",
           "HostPageStore", "MigrationEngine", "MigrationTicket"]
