#!/usr/bin/env python3
"""What ``nvcc -split-compile=0`` would save in building the port's
kernels, and whether it changes the code they run.

    python3 tools/torch_nvcc_split_compile.py

Builds every ``paddle_tpu_torch/csrc`` source twice into a temporary
directory, each time all sources at once (one ``nvcc`` each, as
``ops._build.build_all`` does): first with ``ops._build.NVCC_FLAGS``,
then with ``-split-compile=0`` added. Prints each build's wall, then for
each library the number of kernels whose SASS (``cuobjdump -sass``,
addresses dropped) differs between the two, a few of their names, and
whether ``ptxas -v``'s register and spill lines are the same. Needs
``nvcc`` and ``cuobjdump`` (``/usr/local/cuda/bin``); no card is used.
"""

import hashlib
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["PATH"] = "/usr/local/cuda/bin:" + os.environ.get("PATH", "")

from paddle_tpu_torch.ops import _build  # noqa: E402


def build(out, extra):
    """Build every source with ``extra`` flags; returns ``{name: log}``."""
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(
        ["nvcc", *_build.NVCC_FLAGS, *extra, "-o",
         os.path.join(out, f"{n}.so"), os.path.join(_build.CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for n, src in _build.SOURCES.items()}
    logs = {}
    for n, p in procs.items():
        logs[n] = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            sys.exit(f"{n} failed to build:\n{logs[n][-2000:]}")
    print(f"flags +{extra or '[]'}: all {len(procs)} built together in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return logs


def sass(path):
    """``{kernel: digest of its SASS}``, instruction addresses dropped."""
    text = subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            if line:
                cur.append(line)
    return {k: hashlib.md5("\n".join(v).encode()).hexdigest()
            for k, v in funcs.items()}


def resources(log):
    return sorted(line.strip() for line in log.splitlines()
                  if "Used" in line or "spill" in line)


def main():
    with tempfile.TemporaryDirectory(prefix="nvcc_split_") as tmp:
        base, split = os.path.join(tmp, "base"), os.path.join(tmp, "split")
        os.makedirs(base)
        os.makedirs(split)
        logs_b = build(base, [])
        logs_s = build(split, ["-split-compile=0"])
        for n in _build.SOURCES:
            a = sass(os.path.join(base, f"{n}.so"))
            b = sass(os.path.join(split, f"{n}.so"))
            differ = sorted(set(a) | set(b),
                            key=lambda k: (a.get(k) == b.get(k), k))
            differ = [k for k in differ if a.get(k) != b.get(k)]
            print(f"{n}: {len(a)} kernels, {len(differ)} with other SASS, "
                  f"ptxas resources equal: "
                  f"{resources(logs_b[n]) == resources(logs_s[n])}",
                  flush=True)
            for k in differ[:3]:
                print(f"    {k[:110]}", flush=True)


if __name__ == "__main__":
    main()
