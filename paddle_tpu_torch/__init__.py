"""PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the module paths of ``paddle_tpu`` (a reader finds
each counterpart under the same name) and imports ``torch`` and numpy
only. Its kernels are written by hand for Hopper (``csrc/``) and built
at first use; every kernel keeps a plain PyTorch version beside it,
which is what runs for tensors on the CPU.

It serves Llama-family models through the chunked-prefill engine
(:mod:`paddle_tpu_torch.inference.serving`), whose attention is the
ragged paged attention family
(:mod:`paddle_tpu_torch.ops.ragged_paged_attention`), over bf16 or int8
KV pages; trains them (flash attention, the fused linear
cross-entropy); and serves mixture-of-experts and int8-weight models
(grouped GEMMs, the dequant matmul).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
