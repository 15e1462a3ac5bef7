"""Build, load and launch the port's CUDA kernels; count their launches.

The kernels are plain-C entry points in ``trinity_tpu_torch/csrc/*.cu``,
compiled at first use by ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source,
all started together, then one link) into one shared library under
``trinity_tpu_torch/_build/`` (named by a digest of the sources and flags,
so an edited source never loads a stale build) and bound with ctypes.
Nothing here runs at import: the CPU tests import every module.

Flags: ``-O3`` with ``-fmad=false`` and without ``--use_fast_math`` — IEEE
division and sqrt stay on (nvcc's defaults) and no multiply-add is
contracted, so the kernels keep the reference's f32 operation order.

``launches`` counts, per kernel, the launches made through ``launch`` —
one per wrapper call that reaches the card, exact under threads (warmup
searches from a thread pool). ``reset_launches`` zeroes them. ``load``
builds and binds the library once per process, whichever threads reach
it first.
``bound_ms`` turns the bytes and f32 operations a call must move and do
(the ``*_bytes`` functions of ``ops/``) into the least time an H100 could
take for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from trinity_tpu_torch.utils import seal

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("postings.cu", "fusedscore.cu", "posmask.cu", "phrasescore.cu")
HEADERS = ("decode.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry points: argument kinds, p = pointer (tensor or None), i = int,
# l = 64-bit int;
# every entry point takes the CUDA stream last and returns cudaError_t.
_SIGNATURES = {
    "trin_decode_tiles": "pppppii" "pll" "p",
    "trin_flat_score": "ppppppppp" "iip" "iiii" "pp",
    "trin_tape_score": "pppppip" "piipi" "p" "iip" "iiii" "pp",
    "trin_posmask_tiles": "pppppp" "iii" "pll",
    "trin_phrase_score": "ppppp" "iiiiiii" "pp",
}

# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): device
# memory bytes/s and f32 operations/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12

launches = {"decode": 0, "flat": 0, "tape": 0, "posmask": 0, "phrase": 0}
build_info: dict = {}
_lib = None
_load_lock = threading.Lock()  # one build and bind per process
_count_lock = threading.Lock()  # launches stay exact under threads


def bound_ms(nbytes: int, f32_ops: int = 0):
    """The least time an H100 could take for a call that must move
    `nbytes` and do `f32_ops`: (ms, "bytes" | "operations"), the larger of
    the two times at the card's peak rates."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = f32_ops / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def build() -> str:
    """Compile the kernels if this source set has no build yet; returns the
    library path. Fills ``build_info`` (seconds, path, ptxas report)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    path = os.path.join(BUILD_DIR, f"libtrinity_kernels-{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # per process and thread: no two builders share an object path
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        objs = [f"{tmp}.{s}.o" for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(SOURCES, objs)
        ]
        outs = [(p.communicate()[0], p.returncode) for p in procs]
        log = "".join(o for o, _ in outs)
        if any(rc for _, rc in outs):
            raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        log += r.stdout + r.stderr
        for o in objs:
            os.remove(o)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log[-4000:]}")
        os.replace(tmp, path)
    build_info.update(seconds=time.perf_counter() - t0, path=path, log=log)
    return path


def load():
    """The loaded kernel library (built on first call; threads that reach
    the first call together wait for one build). A build or first bind in
    the process is a variant for the seal (utils/seal.py)."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        path = build()
        seal.record(("kernels", os.path.basename(path)))
        lib = ctypes.CDLL(path)
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "l": ctypes.c_longlong}
        for name, sig in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [kinds[c] for c in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.trin_error_string.argtypes = [ctypes.c_int]
        lib.trin_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(counter: str, entry: str, *args) -> None:
    """Call C entry point `entry` on the current stream of the tensors'
    device and count one launch of kernel `counter`. Tensors pass as
    their data pointers and None as NULL; raises on a non-zero CUDA error."""
    import torch

    lib = load()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    sig = _SIGNATURES[entry]
    if len(args) != len(sig):
        raise TypeError(f"{entry} takes {len(sig)} arguments, got {len(args)}")
    cargs = []
    for kind, a in zip(sig, args):
        if kind == "p":
            if a is not None and (not isinstance(a, torch.Tensor)
                                  or a.device != dev):
                raise TypeError(f"{entry}: pointer argument not on {dev}")
            cargs.append(None if a is None else a.data_ptr())
        else:
            cargs.append(int(a))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*cargs, stream)
    if rc != 0:
        msg = lib.trin_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
    with _count_lock:
        launches[counter] += 1
