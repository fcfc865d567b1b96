"""The port's models: GPT-2 (serving and training) and LLaMA (serving)."""
from .gpt2 import GPT2Config, GPT2LMHeadModel, gpt2_config
from .llama import LlamaConfig, LlamaForCausalLM, llama_config

__all__ = ["GPT2Config", "GPT2LMHeadModel", "gpt2_config", "LlamaConfig", "LlamaForCausalLM",
           "llama_config"]
