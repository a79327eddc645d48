"""Device-memory management: the KV page allocator and pool ops. The
host-RAM tier (`migration`) is not ported (ROADMAP queue 1 item 5.2)."""
from .page_allocator import (PageAllocator, PageExhausted, copy_page,
                             gather_pages, write_pages)

__all__ = ["PageAllocator", "PageExhausted", "copy_page", "write_pages",
           "gather_pages"]
