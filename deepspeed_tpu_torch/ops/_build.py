"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

The JAX package builds its host C++ the same way
(``deepspeed_tpu/ops/native/__init__.py``: compiler → ``_build/`` →
ctypes). Here each ``csrc/<name>.cu`` compiles on its own into
``_build/<name>-<digest>.so`` for ``sm_90a``; the digest covers the
source, every header in ``csrc/`` and the flags, so an edited tree
rebuilds and an unchanged one reuses its libraries. :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them.

Nothing builds when a module is imported: a kernel's first launch builds
its library (or ``build_all`` does so up front). Each C entry returns the
``cudaGetLastError()`` of its launches and :meth:`Kernel.launch` raises
on a non-zero code, so a launch the card refuses never passes silently.

Launches are counted on the host where they are issued: ``Kernel.launches``
per C entry, and each library's own count per device kernel
(:class:`LibraryCounts`). A CUDA graph issues nothing from the host when it
replays, and its capture issues nothing to the card. So a capture runs under
:func:`recording_capture`, which takes the capture's counts back and keeps
them as the graph's launches per replay (:class:`GraphLaunches`), and
:func:`count_replays` adds them once for every replay: the counters read
the same totals as the eager ticks would give.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of the C entries (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
                       "and PATH): the port's CUDA kernels are built from source")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns each compiled source's compiler output
    (``-Xptxas=-v`` registers and spills); raises if any compile fails."""
    names = sources() if names is None else names
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    try:
        for name, target in todo.items():
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            log = target.with_name(f"{target.name}.{os.getpid()}.log")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            with open(log, "w") as fh:   # a file, not a pipe: no full-buffer stall
                proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
            procs[name] = (proc, tmp, log, target)
        logs, failed = {}, []
        for name, (proc, tmp, log, target) in procs.items():
            proc.wait()
            logs[name] = log.read_text()
            if proc.returncode:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, target)   # atomic: a reader sees all or nothing
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return logs
    finally:
        for proc, tmp, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
            log.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.ds_error_string.argtypes = [ctypes.c_int]
            lib.ds_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


# argument kinds of a C entry
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


_KERNELS: "weakref.WeakSet[Kernel]" = weakref.WeakSet()
_LIBRARIES: "weakref.WeakSet[LibraryCounts]" = weakref.WeakSet()
# (source, kernel) -> launches that graph replays made, net of what their
# captures counted without launching
_replayed: Counter = Counter()


class Kernel:
    """One C entry of a csrc library and the count of its launches.

    ``launches`` grows by one for each call of :meth:`launch` whose C entry
    returned success, and nowhere else, and by a graph's launches for each
    of its replays (:func:`count_replays`): a run reads it to show which
    kernels its path went through."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self._fn = None
        _KERNELS.add(self)

    def launch(self, *args) -> None:
        fn = self._fn
        if fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = fn(*args)
        if err:
            msg = load(self.source).ds_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


class LibraryCounts:
    """A C library's own launch counts by device kernel: ``symbol(i)``
    returns the launches of ``names[i]``, counted where the library
    launches it. :meth:`read` adds what graph replays launched."""

    def __init__(self, source: str, symbol: str, names: tuple):
        self.source, self.symbol, self.names = source, symbol, tuple(names)
        _LIBRARIES.add(self)

    def loaded(self) -> bool:
        return self.source in _libs

    def raw(self) -> dict:
        """The library's counters as they stand. Loads (and builds) it."""
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes, fn.restype = [INT], ctypes.c_ulonglong
        return {name: int(fn(i)) for i, name in enumerate(self.names)}

    def read(self) -> dict:
        """Launches so far of each kernel, replays of captured graphs included."""
        return {name: n + _replayed[(self.source, name)] for name, n in self.raw().items()}


@dataclasses.dataclass
class GraphLaunches:
    """The launches one replay of a captured graph makes: per C entry
    (``kernels``) and per library kernel (``library``, keyed by (source,
    kernel))."""

    kernels: dict = dataclasses.field(default_factory=dict)
    library: dict = dataclasses.field(default_factory=dict)


def _counts() -> tuple:
    """Every counter as it stands; a library not yet loaded counts 0."""
    kernels = {k: k.launches for k in list(_KERNELS)}
    library = Counter()
    for lib in list(_LIBRARIES):
        if lib.loaded():
            for name, n in lib.raw().items():
                library[(lib.source, name)] = n
    return kernels, library


@contextlib.contextmanager
def recording_capture():
    """Around a graph capture: yields the :class:`GraphLaunches` it fills
    with what the capture counted, and takes those counts back, since a
    capture issues nothing to the card. Replays add them
    (:func:`count_replays`)."""
    rec = GraphLaunches()
    k0, l0 = _counts()
    try:
        yield rec
    finally:
        k1, l1 = _counts()
        for k, n in k1.items():
            d = n - k0.get(k, 0)
            if d:
                rec.kernels[k] = d
                k.launches -= d
        for key, n in l1.items():
            d = n - l0.get(key, 0)
            if d:
                rec.library[key] = d
                _replayed[key] -= d


def count_replays(rec: GraphLaunches, replays: int) -> None:
    """Add ``replays`` replays of a graph's launches to every counter."""
    for k, d in rec.kernels.items():
        k.launches += d * replays
    for key, d in rec.library.items():
        _replayed[key] += d * replays


def capturing() -> bool:
    """True while the current stream is under graph capture (never without
    CUDA, where no graph is captured)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16 tensors, not {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check_operands(*tensors: torch.Tensor, dtypes=None) -> None:
    """Device, dtype, contiguity and alignment checks before pointers reach C.

    ``dtypes``: the dtype each operand must have, one per operand (a W8A16
    launch mixes activations, int8 codes and fp32 scales); None: every
    operand shares the first one's."""
    dev = tensors[0].device
    if dtypes is None:
        dtypes = [tensors[0].dtype] * len(tensors)
    if len(dtypes) != len(tensors):
        raise ValueError(f"{len(tensors)} kernel operands, {len(dtypes)} dtypes")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"kernel operands on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"kernel operand of dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
