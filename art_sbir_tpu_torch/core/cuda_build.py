"""Building, loading and counting the port's hand-written CUDA kernels.

A kernel's source ``csrc/<name>.cu`` and the shared headers ``csrc/*.cuh``
are compiled by ``nvcc`` for ``sm_90a`` at first use into
``art_sbir_tpu_torch/_build/``, keyed by a hash of the sources and flags,
and the library is loaded with ``ctypes``. The compiler's report
(registers, shared memory, spills) is kept beside it as ``.log``. Each
source exports one C function that launches on the given stream, does
not synchronise and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BLOCKS_PER_SM = 4  # gallery splits fill the card this many blocks deep
MAX_SPLITS = 1024  # the merges' run heads: 4 per thread x 256 threads


class LaunchCounters:
    """Plain integer counts: ``launches`` of a CUDA kernel and
    ``fallback_rows`` recomputed by the plain route after a failed
    certificate. Thread-safe (the micro-batcher and HTTP handler threads
    both search)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.fallback_rows = 0

    def add(self, launches: int = 0, fallback_rows: int = 0) -> None:
        with self._lock:
            self.launches += launches
            self.fallback_rows += fallback_rows

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.fallback_rows = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the kernels under "
                       f"{CSRC} are compiled on the machine with the card")


class CudaKernel:
    """One ``csrc/<name>.cu`` source and its exported C ``symbol``.
    ``argtypes`` are ctypes types: ``c_void_p`` for every pointer and the
    stream, ``c_int`` for every int. ``label`` names the kernel in
    errors."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 label: str):
        self.source = CSRC / f"{name}.cu"
        self.name, self.symbol, self.label = name, symbol, label
        self.argtypes = list(argtypes)
        self._lock = threading.Lock()
        self._fns = {}

    def build(self) -> Path:
        """Compile into ``_build/`` (once per sources and flags) and return
        the shared library's path."""
        blob = self.source.read_bytes() + b"".join(
            p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.name}_{digest}.so"
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def call(self, symbol: str, argtypes: Sequence, *args) -> None:
        """Call the exported C function ``symbol`` (building the library at
        first use); raise if it returns a CUDA error."""
        with self._lock:
            fn = self._fns.get(symbol)
            if fn is None:
                fn = getattr(ctypes.CDLL(str(self.build())), symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                self._fns[symbol] = fn
        err = fn(*args)
        if err:
            raise RuntimeError(f"{self.label} {symbol} failed: CUDA error {err}")

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch was refused."""
        self.call(self.symbol, self.argtypes, *args)

    def ask(self, symbol: str, args: Sequence[int], n_out: int,
            device_index: int) -> tuple:
        """Call the exported C function ``symbol(int..., int* ...)`` on the
        card ``device_index`` with the int ``args`` and ``n_out`` int
        outputs (a kernel's shape: its tile, the blocks that fit on an SM);
        return the outputs."""
        outs = [ctypes.c_int() for _ in range(n_out)]
        with torch.cuda.device(device_index):
            self.call(symbol, [ctypes.c_int] * len(args)
                      + [ctypes.POINTER(ctypes.c_int)] * n_out, *args,
                      *(ctypes.byref(o) for o in outs))
        return tuple(o.value for o in outs)


_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def scratch(device: torch.device, nbytes: int) -> torch.Tensor:
    """A byte buffer of at least ``nbytes`` on ``device`` for a kernel's
    scratch, kept from call to call for each (device, current stream).
    Launches on one stream run in order, so a later launch on it cannot
    touch the buffer while an earlier one uses it; hold the returned
    tensor until the launch is queued (a larger request replaces the
    buffer, and the old one is freed once no caller holds it)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    with _SCRATCH_LOCK:
        buf = _SCRATCH.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                              device=device)
            _SCRATCH[key] = buf
    return buf


class Plans:
    """What a launch over a fixed gallery derives from its tensors once
    (their checks, the host arrays of their pointers), kept by the
    tensors' :func:`signature`: a gallery's shards do not change between
    calls, so their checks are not repeated a call."""

    def __init__(self, size: int = 64):
        self._lock = threading.Lock()
        self._plans = {}
        self._size = size

    def get(self, key, make):
        """The plan of ``key``, made by ``make()`` (which raises on bad
        tensors) the first time."""
        with self._lock:
            plan = self._plans.get(key)
        if plan is None:
            plan = make()
            with self._lock:
                if len(self._plans) >= self._size:
                    self._plans.clear()
                self._plans[key] = plan
        return plan


def signature(tensors) -> tuple:
    """What a check of ``tensors`` depends on: address, shape, strides,
    type and device of each."""
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
                 for t in tensors)


def grid_splits(q_tiles: int, n_tiles: int, device: torch.device,
                per_sm: int = BLOCKS_PER_SM) -> int:
    """Gallery splits of a two-pass sweep: as many blocks as fill the card
    once, ``BLOCKS_PER_SM`` deep or ``per_sm`` deep where fewer blocks fit
    on an SM at once, and no more (a block past the first wave would run
    alone after it), at most one split per gallery tile and at most
    ``MAX_SPLITS``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, min(BLOCKS_PER_SM, per_sm))
    return max(1, min(n_tiles, MAX_SPLITS, per_sm * sms // q_tiles))
