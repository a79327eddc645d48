"""Model families (GPT)."""
from .gpt import GPT, GPTConfig, gpt2_124m, gpt_tiny

__all__ = ["GPT", "GPTConfig", "gpt2_124m", "gpt_tiny"]
