"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``.  The build happens at first use, from the sources in the
checkout only, into ``build/`` at the repository root, under a directory
keyed on a hash of the sources (and the flags), so an edited kernel is
rebuilt and an unchanged one is loaded as it is.  All sources compile in
parallel, one ``nvcc`` each.

``launches`` counts kernel launches by kernel name; each wrapper adds
one (:func:`count`) where it launches its kernel and nowhere else.
``design_launches`` counts the same launches by the design that ran them:
``skinny_wgmma`` / ``skinny_stream`` / ``skinny_f32`` /
``skinny_tf32x3`` (``csrc/tsmm_skinny.cu``), ``tall_wgmma`` / ``tall_f32`` /
``tall_tf32x3`` (``csrc/tsmm_tall.cu``), ``flash_wgmma`` / ``flash_simt``
(``csrc/flash_attention.cu``), ``pack_tma`` / ``pack_vec``
(``csrc/pack_blocks.cu``).  ``epilogue_launches`` counts the launches
that fused an activation into their epilogue, by kernel and epilogue
(``tsmm_skinny_a/bias_gelu``).  A launch made while a CUDA graph captures
runs nothing: inside :func:`recording` it is counted into the recorder
instead, and :func:`replayed` adds a recorder's counts once per replay
of the graph (``serve/programs.py``), so counts under graphs equal the
eager counts.  ``stream`` gives a launch its stream.
``csrc/hopper.cuh`` holds the helpers the Hopper designs share.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("tsmm_skinny", "tsmm_tall", "pack_blocks", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Counter = Counter()
design_launches: Counter = Counter()
epilogue_launches: Counter = Counter()

_lock = threading.Lock()
_libs: dict = {}
build_report: dict = {}


_recorder = threading.local()


def reset_launches() -> None:
    launches.clear()
    design_launches.clear()
    epilogue_launches.clear()


def count(name: str, design: str, epilogue: str | None = None) -> None:
    """Count one launch of kernel ``name`` by ``design`` (and, when it
    fused an activation, by ``epilogue``): into the calling thread's
    recorder while one is open, else into ``launches``,
    ``design_launches`` and ``epilogue_launches``."""
    rec = getattr(_recorder, "counts", None)
    counters = rec if rec is not None else (launches, design_launches,
                                            epilogue_launches)
    counters[0][name] += 1
    counters[1][design] += 1
    if epilogue:
        counters[2][f"{name}/{epilogue}"] += 1


@contextlib.contextmanager
def recording():
    """Count the calling thread's launches into a recorder, (by kernel,
    by design, by epilogue), instead of the global counts: what a graph
    capture launches has not run.  Other threads keep counting
    globally."""
    prev = getattr(_recorder, "counts", None)
    _recorder.counts = (Counter(), Counter(), Counter())
    try:
        yield _recorder.counts
    finally:
        _recorder.counts = prev


def replayed(rec) -> None:
    """Add a recorder's counts once: one replay of what it recorded."""
    for counter, counts in zip((launches, design_launches,
                                epilogue_launches), rec):
        counter.update(counts)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def _declare(libs: dict) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    f = libs["tsmm_skinny"].tsmm_skinny_launch
    # x, w, bias, out, scratch, m, K, N, ldx, bk, bn, natural, splits,
    # mode, act, dtype, design, bm, nt, cluster, stages, stream
    f.argtypes = [p, p, p, p, p] + [i] * 16 + [p]
    f.restype = i
    f = libs["tsmm_tall"].tsmm_tall_launch
    # a, b, bias, out, scratch, M, K, N, packed, pbm, pbk, kbeg, kps,
    # splits, design, bm, nt, cluster, stages, mode, act, dtype, stream
    f.argtypes = [p, p, p, p, p] + [i] * 17 + [p]
    f.restype = i
    f = libs["pack_blocks"].pack_blocks_launch
    # a, out, L, M, K, bm, bk, alpha, dtype, design, rows, grid, threads,
    # stages, box, stream
    f.argtypes = [p, p, i, i, i, i, i, ctypes.c_float] + [i] * 7 + [p]
    f.restype = i
    f = libs["flash_attention"].flash_attention_launch
    # q, k, v, out, B, Sq, Sk, H, KH, D, q strides (b, s, h), k strides,
    # v strides, out strides, causal, dtype, design, stream
    f.argtypes = [p, p, p, p, i, i, i, i, i, i] + [ctypes.c_longlong] * 12 \
        + [i, i, i, p]
    f.restype = i


def load() -> dict:
    """Build (if needed) and load every kernel library; returns
    ``{source name: ctypes.CDLL}``.  ``build_report`` records the build's
    seconds and each source's ``-Xptxas -v`` register/shared-memory
    report."""
    with _lock:
        if _libs:
            return _libs
        out = _build_dir()
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SOURCES:
            lib = out / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out / f".lib{name}.{os.getpid()}.so"
            procs[name] = (tmp, lib, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        ptxas = {}
        failed = []
        for name, (tmp, lib, proc) in procs.items():
            log, _ = proc.communicate()
            ptxas[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        build_report.update(seconds=time.perf_counter() - t0,
                            built=sorted(procs), dir=str(out), ptxas=ptxas)
        libs = {name: ctypes.CDLL(str(out / f"lib{name}.so"))
                for name in SOURCES}
        _declare(libs)
        _libs.update(libs)
        return _libs


# PyTorch's accessor of the current stream's raw handle (the one its own
# generated kernels call), which skips building a Stream object on every
# launch of the host-bound decode step; the public accessor where a build
# lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launch."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")
