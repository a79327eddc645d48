"""Core helpers: the env-flag catalog subset and device resolution."""
