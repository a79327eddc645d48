"""Model families (GPT)."""
from .gpt import GPT, GPTConfig, gpt2_124m, gpt2_345m, gpt3_1p3b, gpt_tiny

__all__ = ["GPT", "GPTConfig", "gpt2_124m", "gpt2_345m", "gpt3_1p3b",
           "gpt_tiny"]
