"""The training engine and what it is configured with."""
