"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and linked into ONE shared library with a plain C interface,
loaded with ``ctypes``.  No PyTorch headers are included, so a build takes
seconds.  The library is cached in ``build/`` (gitignored) under a content
hash of the sources and the flags: mtimes are not preserved by git, so they
cannot key it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# entry point -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    # frame, linesize, wc, n_wc_rows, rows, n_rows, groups, const, huff,
    # ys, ybits, us, ubits, vs, vbits, ovf, layout, nmcux, nmcu,
    # restart_interval, wwords, stream
    "ug_jpeg_encode": [_P, _L, _P, _I, _P, _I, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _P],
    # frame, linesize, w, const, huff, ys, ybits, us, ubits, vs, vbits, ovf,
    # layout, nmcux, nmcu, restart_interval, wwords, stream
    "ug_jpeg_plane_encode": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
    # pinned staging buffer, source, bytes, device buffer, stream
    "ug_jpeg_upload": [_P, _P, _L, _P, _P],
    # file, len, scan start, tables, table ids (Y, chroma), nmcu,
    # restart interval, nseg, tile counts, ntiles, offsets, q, status,
    # first segment, end segment, stream
    "ug_jpeg_decode": [_P, _L, _L, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P],
    # ys, ybits, us, ubits, vs, vbits, overflow byte, nmcu, ky, wwords,
    # restart interval, first segment, scratch, segment bytes, segment
    # lengths, offsets, info, stream
    "ug_jpeg_assemble_count": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # scratch, segment bytes, offsets, nmcu, ky, wwords, restart interval,
    # first segment, eoi, body, stream
    "ug_jpeg_assemble_write": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P],
    # part pointers, part words per frame, part first rows (host arrays),
    # nparts, nframes, psw, row_ptr, cols, m, nnz, staircase, out, stream
    "ug_gf2_parity": [_P, _P, _P, _I, _I, _L, _P, _P, _I, _I, _I, _P, _P],
}


class LaunchCounter:
    """How many times a wrapper launched its kernel (never its plain
    version): ``count`` in all, ``per_device`` by card index.  Wrappers
    called from several threads at once count with :meth:`add`."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.per_device = {}
        self._lock = threading.Lock()

    def add(self, device) -> None:
        """One launch on ``device`` (a ``torch.device``)."""
        with self._lock:
            self.count += 1
            self.per_device[device.index] = self.per_device.get(device.index, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.per_device = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (need the CUDA toolkit to build csrc/*.cu)")
    return path


def library_path() -> str:
    """Path of the built library, building it if the cache has no match."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256()
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so_path = os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:12]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one nvcc per source, all started together, then one link; build in a
    # temporary directory and rename: a concurrent loader never sees a
    # half-written library
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        logs = []
        for cmd, p in zip(cmds, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{err}")
            logs.append(err)
        tmp = os.path.join(tmpdir, "kernels.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{res.stderr}")
        with open(so_path[:-3] + ".log", "w") as f:
            f.write("".join(logs))
        os.replace(tmp, so_path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return so_path


def build_log() -> str:
    """nvcc's messages (``-Xptxas -v``: registers, shared memory, spills)."""
    log = library_path()[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


@lru_cache(maxsize=None)
def kernels_lib(keep_gil: bool = False) -> ctypes.CDLL:
    """The library.  ``keep_gil``: its functions hold the interpreter lock
    while they run (``ctypes.PyDLL``), for calls short enough that handing
    the lock to another thread and waiting to get it back costs more."""
    lib = (ctypes.PyDLL if keep_gil else ctypes.CDLL)(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ug_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ug_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = kernels_lib().ug_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
