"""The port's models (GPT-2 for the serving slice)."""
