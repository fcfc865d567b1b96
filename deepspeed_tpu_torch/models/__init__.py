"""The port's models: GPT-2 (serving and training), LLaMA and GPT-NeoX
(serving)."""
from .gpt2 import GPT2Config, GPT2LMHeadModel, gpt2_config
from .gptneox import GPTNeoXConfig, GPTNeoXForCausalLM, gptneox_config
from .llama import LlamaConfig, LlamaForCausalLM, llama_config

__all__ = ["GPT2Config", "GPT2LMHeadModel", "gpt2_config", "GPTNeoXConfig", "GPTNeoXForCausalLM",
           "gptneox_config", "LlamaConfig", "LlamaForCausalLM", "llama_config"]
