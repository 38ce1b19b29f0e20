from .llama import (LlamaConfig, LlamaForCausalLM, LlamaMoEMLP,
                    llama3_8b_config, tiny_llama_config)
from .convert import load_numpy_state

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaMoEMLP",
           "llama3_8b_config", "tiny_llama_config", "load_numpy_state"]
