"""The port stands alone: importing it loads neither jax nor the
reference package, and no file of it names either."""

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
           "paddle_tpu_torch.quant.kernels", "paddle_tpu_torch.quant.layers"]


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
