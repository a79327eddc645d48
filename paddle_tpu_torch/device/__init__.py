"""paddle.device: `set_device` / `get_device` (see `core.device`)."""
from ..core.device import get_device, set_device

__all__ = ["set_device", "get_device"]
