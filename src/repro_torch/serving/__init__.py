"""Serving: paged engine, step loop, page allocator."""
