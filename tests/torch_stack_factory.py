"""Model factory for the subprocess replicas of
``tests/test_torch_subprocess_cluster.py``: the port's tiny Llama on the
CPU with the weights the test wrote to ``$PADDLE_TPU_TEST_WEIGHTS`` (an
``.npz`` of the fitted reference model's state). A worker names it in its
spec as ``{"model": {"factory": "tests.torch_stack_factory:build_model"}}``.
"""

import os

import numpy as np
import torch


def build_model():
    from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                         tiny_llama_config)
    torch.set_num_threads(1)
    with np.load(os.environ["PADDLE_TPU_TEST_WEIGHTS"]) as z:
        arrays = {k: z[k] for k in z.files}
    model = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    return load_numpy_state(model, arrays).eval()
