"""Model families (GPT decode side)."""
