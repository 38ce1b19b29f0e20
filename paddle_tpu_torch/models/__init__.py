from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel, LlamaMoEMLP,
                    llama3_8b_config, shard_llama, tiny_llama_config)
from .convert import load_numpy_state

__all__ = ["LlamaConfig", "LlamaMLP", "LlamaMoEMLP", "LlamaAttention",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "llama3_8b_config", "tiny_llama_config", "load_numpy_state",
           "shard_llama"]
