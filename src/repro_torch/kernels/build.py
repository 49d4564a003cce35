"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Builds happen at first use, from the sources in this
checkout only, into ``<repo>/build/repro_torch/`` (listed in .gitignore).
The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a stale build is never loaded.
``build()`` compiles several sources at once, one ``nvcc`` process each,
all started together.

Each wrapper counts its kernel's launches in ``<wrapper>.launches`` through
``count_launch``. A CUDA graph capture records a launch without running it:
inside ``captured_launches()`` such a call is noted for the graph instead,
and whoever replays the graph adds the noted launches at each replay.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("threshold_find", "fused_merge", "overlap_combine", "block_topk",
           "ef_update", "flash_attention", "flash_attention_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CAPABILITY = (9, 0)
#: while ``captured_launches`` is open: the wrappers whose kernel a CUDA
#: graph capture recorded, one entry per recorded launch
_captured = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the Hopper kernels are built from source")
    return nvcc


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed on its content
    and that of every header in ``csrc/``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def check_device() -> None:
    """The kernels target Hopper (sm_90a) only: anything else raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("the Hopper kernels need CUDA; "
                           "torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability()
    if cap != CAPABILITY:
        raise RuntimeError(
            f"the kernels are built for sm_90a (capability {CAPABILITY}); "
            f"this device ({torch.cuda.get_device_name()}) has {cap}")


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every missing library among ``names`` in parallel; returns
    name -> library path. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        path = todo[name]
        path.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)    # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` for the current device."""
    check_device()
    return ctypes.CDLL(str(build([name])[name]))


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``.
    Under CUDA graph capture nothing launches: the launch is noted for
    ``captured_launches`` (outside it, it is not counted at all)."""
    if torch.cuda.is_current_stream_capturing():
        if _captured is not None:
            _captured.append(wrapper)
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def captured_launches():
    """Collect the kernel launches a CUDA graph capture records. Yields a
    Counter, filled when the block ends: wrapper -> launches of its kernel
    in one replay of the captured graph."""
    global _captured
    per_replay = collections.Counter()
    outer, _captured = _captured, []
    try:
        yield per_replay
    finally:
        per_replay.update(_captured)
        _captured = outer
