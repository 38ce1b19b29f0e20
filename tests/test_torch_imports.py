"""The port stands alone: importing it loads neither jax nor the
reference package, and no file of it names either. Each ported module
exports the reference's public names, but those that unported ROADMAP
items bring."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"
MODULES = ["paddle_tpu_torch", "paddle_tpu_torch.device",
           "paddle_tpu_torch.incubate.nn.functional",
           "paddle_tpu_torch.models.llama", "paddle_tpu_torch.models.convert",
           "paddle_tpu_torch.inference.paged_cache",
           "paddle_tpu_torch.inference.serving",
           "paddle_tpu_torch.inference.sampling",
           "paddle_tpu_torch.inference.prefix_cache",
           "paddle_tpu_torch.inference.kv_tier",
           "paddle_tpu_torch.observability",
           "paddle_tpu_torch.observability.metrics",
           "paddle_tpu_torch.observability.trace",
           "paddle_tpu_torch.observability.tracing",
           "paddle_tpu_torch.observability.slo",
           "paddle_tpu_torch.observability.export",
           "paddle_tpu_torch.observability.flight_recorder",
           "paddle_tpu_torch.observability.compile_watch",
           "paddle_tpu_torch.observability.perf",
           "paddle_tpu_torch.ops._graphs",
           "paddle_tpu_torch.testing", "paddle_tpu_torch.testing.faults",
           "paddle_tpu_torch.distributed.watchdog",
           "paddle_tpu_torch.distributed",
           "paddle_tpu_torch.distributed.net_store",
           "paddle_tpu_torch.distributed.rpc",
           "paddle_tpu_torch.native", "paddle_tpu_torch.native.build",
           "paddle_tpu_torch.inference.qos",
           "paddle_tpu_torch.inference.cluster",
           "paddle_tpu_torch.inference.frontend",
           "paddle_tpu_torch.inference.replica_worker",
           "paddle_tpu_torch.examples.llama_serving",
           "paddle_tpu_torch.ops.sampling",
           "paddle_tpu_torch.ops.ragged_paged_attention",
           "paddle_tpu_torch.ops.paged_attention",
           "paddle_tpu_torch.ops._build",
           "paddle_tpu_torch.ops.flash_attention",
           "paddle_tpu_torch.ops.fused_linear_cross_entropy",
           "paddle_tpu_torch.nn.functional", "paddle_tpu_torch.amp",
           "paddle_tpu_torch.distributed.recompute",
           "paddle_tpu_torch.optimizer", "paddle_tpu_torch.io",
           "paddle_tpu_torch.optimizer.lr", "paddle_tpu_torch.regularizer",
           "paddle_tpu_torch.nn", "paddle_tpu_torch.nn.clip",
           "paddle_tpu_torch.io.token_feed",
           "paddle_tpu_torch.distributed.checkpoint",
           "paddle_tpu_torch.distributed.checkpoint_manager",
           "paddle_tpu_torch.jit",
           "paddle_tpu_torch.examples.llama_pretrain",
           "paddle_tpu_torch.incubate.moe", "paddle_tpu_torch.ops.grouped_gemm",
           "paddle_tpu_torch.ops._tile_gemm",
           "paddle_tpu_torch.quant", "paddle_tpu_torch.quant.format",
           "paddle_tpu_torch.quant.kernels", "paddle_tpu_torch.quant.layers",
           "paddle_tpu_torch.framework", "paddle_tpu_torch.framework.io",
           "paddle_tpu_torch.io.dataset", "paddle_tpu_torch.io.sampler",
           "paddle_tpu_torch.io.dataloader", "paddle_tpu_torch.metric",
           "paddle_tpu_torch.amp.grad_scaler", "paddle_tpu_torch.hapi",
           "paddle_tpu_torch.hapi.callbacks",
           "paddle_tpu_torch.hapi.model_summary",
           "paddle_tpu_torch.hapi.hub", "paddle_tpu_torch.flags",
           "paddle_tpu_torch.framework.dispatch",
           "paddle_tpu_torch.amp.debugging", "paddle_tpu_torch.quantization",
           "paddle_tpu_torch.quant.bridge",
           "paddle_tpu_torch.quant.checkpoint",
           "paddle_tpu_torch.quant.quality", "paddle_tpu_torch.incubate",
           "paddle_tpu_torch.distributed.env",
           "paddle_tpu_torch.distributed.collective",
           "paddle_tpu_torch.distributed.p2p",
           "paddle_tpu_torch.distributed.process_mesh",
           "paddle_tpu_torch.distributed.placement",
           "paddle_tpu_torch.distributed.api",
           "paddle_tpu_torch.distributed.plan",
           "paddle_tpu_torch.distributed.parallel",
           "paddle_tpu_torch.distributed.mp_layers",
           "paddle_tpu_torch.distributed.fleet"]


def test_import_leaves_jax_unloaded():
    """Every module, the serving stack's lazy names included, imports with
    neither jax nor any reference module loaded."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "inf = importlib.import_module('paddle_tpu_torch.inference')\n"
            "for name in inf._LAZY:\n"
            "    getattr(inf, name)\n"
            "tf = importlib.import_module('paddle_tpu_torch.io.token_feed')\n"
            "assert tf.TokenFeed and tf.PyTokenFeed\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*")
    if p.suffix in (".py", ".cu", ".cuh", ".cc")))
def test_source_names_neither_jax_nor_reference(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"jax", text, re.IGNORECASE), path
    assert "paddle_tpu." not in text, path


def test_scan_covers_native_sources():
    """The C++ sources copied into the port (the TCP store and the token
    feed) are among the files the scan above reads."""
    scanned = {p.name for p in PKG.rglob("*.cc")}
    assert {"tcp_store.cc", "data_feed.cc"} <= scanned


#: reference names the port keeps under another name: the plain versions
#: of the kernels are ``*_ref`` in the port (no XLA formulation there), and
#: a mesh's ``to_jax_mesh`` is ``ProcessMesh.to_device_mesh`` (a torch
#: ``DeviceMesh``)
RENAMED = {
    "to_jax_mesh": "to_device_mesh",
    "dequant_matmul_xla": "dequant_matmul_ref",
    "grouped_gemm_xla": "grouped_gemm_ref",
    "grouped_gemm_q8_xla": "grouped_gemm_q8_ref",
    "paged_attention_xla": "paged_attention_ref",
    "ragged_paged_attention_xla": "ragged_paged_attention_ref",
    "fused_ragged_paged_attention_xla": "fused_ragged_paged_attention_ref",
    "fused_linear_cross_entropy_xla": "fused_linear_cross_entropy_ref",
}

#: reference names that unported items bring, by module, each with its item
PENDING = {
    "paddle_tpu_torch.device": ("ROADMAP A14b (device/__init__.py)", {
        "Event", "Stream", "cuda", "current_stream", "device_count",
        "empty_cache", "get_all_devices", "get_device",
        "is_compiled_with_cuda", "is_compiled_with_custom_device",
        "is_compiled_with_ipu", "is_compiled_with_rocm",
        "is_compiled_with_xpu", "max_memory_allocated", "memory_allocated",
        "memory_reserved", "memory_stats", "reset_max_memory_allocated",
        "set_device", "synchronize"}),
    "paddle_tpu_torch.incubate.nn": ("ROADMAP A14f (incubate/nn/layer.py)", {
        "FusedBiasDropoutResidualLayerNorm", "FusedDropoutAdd",
        "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
        "FusedTransformerEncoderLayer"}),
    "paddle_tpu_torch.incubate.nn.functional": (
        "ROADMAP A14b (the four fused incubate ops)", {
            "fused_bias_act", "fused_dropout_add", "fused_layer_norm",
            "fused_linear"}),
    "paddle_tpu_torch.inference": ("ROADMAP A14a (the deploy path)", {
        "Config", "Predictor", "create_predictor"}),
    "paddle_tpu_torch.jit": ("ROADMAP A14a (the deploy path)", {
        "TranslatedLayer"}),
    "paddle_tpu_torch.models": (
        "ROADMAP A13 part 2 (the pipeline model) and A14e (BERT / "
        "ERNIE)", {
            "BertConfig", "BertForSequenceClassification",
            "BertForTokenClassification", "BertModel",
            "ErnieForSequenceClassification", "ErnieModel",
            "ernie_base_config", "tiny_bert_config",
            "LlamaForCausalLMPipe"}),
    "paddle_tpu_torch.nn.functional.attention": (
        "ROADMAP A14d (sdp_kernel switches the reference's kernels by a "
        "flag; no flag switches a port kernel off)", {"sdp_kernel"}),
    "paddle_tpu_torch.nn.functional.loss": (
        "ROADMAP A14d (nn/functional)", {
            "binary_cross_entropy", "binary_cross_entropy_with_logits",
            "cosine_embedding_loss", "ctc_loss", "edit_distance",
            "gaussian_nll_loss", "hinge_embedding_loss", "hsigmoid_loss",
            "huber_loss", "identity_loss", "kl_div", "l1_loss", "log_loss",
            "margin_cross_entropy", "margin_ranking_loss", "mse_loss",
            "multi_label_soft_margin_loss", "nll_loss", "poisson_nll_loss",
            "rnnt_loss", "sigmoid_focal_loss", "smooth_l1_loss",
            "softmax_with_cross_entropy", "square_error_cost",
            "triplet_margin_loss"}),
    "paddle_tpu_torch.ops.fused_linear_cross_entropy": (
        "ROADMAP A14d (the reference's TPU kernel rule; the port's kernel "
        "takes every shape, kernel_instance)", {"supported"}),
}


def _ported_modules():
    """The port's modules whose reference counterpart exists (the same
    path under ``paddle_tpu/``)."""
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG)
        if not (ROOT / "paddle_tpu" / rel).exists() and not (
                ROOT / "paddle_tpu" / rel.with_suffix("")
                / "__init__.py").exists():
            continue
        parts = ["paddle_tpu_torch"] + list(rel.with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


@pytest.mark.parametrize("module", _ported_modules())
def test_all_matches_the_reference(module):
    """Every name of the reference module's ``__all__`` is in the port's
    (under its port name), but the names :data:`PENDING` lists for an
    unported item; a listed name the port now has fails, so the list
    shrinks as items land."""
    import importlib
    ref_name = "paddle_tpu" + module[len("paddle_tpu_torch"):]
    port = importlib.import_module(module)
    ref = importlib.import_module(ref_name)
    ref_all = getattr(ref, "__all__", None)
    if ref_all is None:
        return
    item, pending = PENDING.get(module, ("", set()))
    port_all = set(getattr(port, "__all__", ()))
    missing = sorted(RENAMED.get(n, n) for n in ref_all
                     if RENAMED.get(n, n) not in port_all
                     and n not in pending)
    assert not missing, missing
    for n in ref_all:
        assert hasattr(port, RENAMED.get(n, n)) or n in pending, n
    landed = sorted(n for n in pending if n in port_all)
    assert not landed, f"{landed} are ported: take them off {item}"
    assert pending <= set(ref_all)
