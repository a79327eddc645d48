"""paddle_tpu_torch.testing: deterministic fault-injection tooling.

`chaos` is the JAX package's injection harness, copied: the same site
names, rule grammar and PADDLE_TPU_CHAOS variable. It is import-light
(it imports only `core.flags`), so production modules hook injection
sites unconditionally.
"""
from . import chaos  # noqa: F401

__all__ = ["chaos"]
