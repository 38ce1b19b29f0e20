"""Shared pieces of the serving-stack parity tests
(``tests/test_torch_cluster.py``, ``test_torch_frontend.py``,
``test_torch_subprocess_cluster.py``): the fitted tiny model's weights,
fitted once a test session and shared by the xdist workers through a
file, both packages' models over them, and the oracle, the reference
engine's ``fused_kv=False`` path (the trusted one on the CPU).
"""

import fcntl
import os

import numpy as np
import torch

#: the engines' geometry in every serving-stack test
GEOM = dict(max_batch=2, page_size=8, num_pages=48)
FIT_STEPS = 20
NEW = 6


def fitted_path(tmp_path_factory):
    """The ``.npz`` of the tiny model's weights after ``fit_on_prompts``
    (seed 0): the first worker of a session fits and writes it, the
    others wait for it."""
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import tiny_llama_config as jax_tiny
    from paddle_tpu.quant import quality

    root = tmp_path_factory.getbasetemp().parent
    path = root / f"torch_stack_fitted_{FIT_STEPS}.npz"
    with open(root / "torch_stack_fitted.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            paddle.seed(0)
            jm = JaxLlama(jax_tiny())
            quality.fit_on_prompts(jm, steps=FIT_STEPS)
            arrays = {k: np.array(v._data)
                      for k, v in jm.state_dict().items()}
            tmp = root / f"{path.stem}.{os.getpid()}.npz"
            np.savez(tmp, **arrays)
            os.replace(tmp, path)
    return path


def fitted_arrays(tmp_path_factory):
    with np.load(fitted_path(tmp_path_factory)) as z:
        return {k: z[k] for k in z.files}


def reference_model(arrays):
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import tiny_llama_config as jax_tiny

    jm = JaxLlama(jax_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    jm.eval()
    return jm


def port_model(arrays):
    from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                         tiny_llama_config)
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    return load_numpy_state(tm, arrays).eval()


def prompts(seed, lens, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def oracle(jax_model, prompt_list, new=NEW):
    """Each prompt's greedy continuation by the reference engine's
    ``fused_kv=False`` path, one engine for all."""
    from paddle_tpu.inference.serving import LlamaServingEngine
    e = LlamaServingEngine(jax_model, fused_kv=False, prefix_cache=False,
                           **GEOM)
    try:
        return [list(o) for o in e.generate(prompt_list,
                                            max_new_tokens=new)]
    finally:
        e.close()


def one_thread():
    # One intra-op thread a process: the suite runs in parallel worker
    # processes (xdist), and OpenMP threads that spin for a core each
    # slow every small CPU op of the port many times over.
    torch.set_num_threads(1)
