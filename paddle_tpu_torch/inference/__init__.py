"""Serving: the paged decode engine (`decode`) and its server (`serve`)."""
