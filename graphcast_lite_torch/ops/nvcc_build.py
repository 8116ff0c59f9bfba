"""Build and load the package's CUDA kernel libraries.

Every ``csrc/*.cu`` of the package is a plain C interface compiled by nvcc
for ``sm_90a`` into a shared library and bound with ctypes.  A library is
built at first use into the package's gitignored ``_build/`` directory,
under a name that hashes the source text, its headers and the nvcc flags,
so a library built from another source or with other flags is never
loaded.

``build(*sources)`` starts one nvcc per missing library, all at once, and
waits for them; ``load(source, signatures)`` builds (if needed), opens and
binds one library, once per process.  ``edited_copy`` writes a source with
the package's headers, text edits applied to all of them, for the timing
scripts' variants of a kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence, Tuple

import torch

__all__ = ["CSRC", "NVCC_FLAGS", "DTYPE_CODES", "lib_path", "build", "load",
           "edited_copy"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# The dtype codes every C interface of the package takes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# name -> (restype, argtypes) of the C functions a library exports.
Signatures = Dict[str, Tuple[object, Sequence[object]]]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def lib_path(source: str) -> str:
    """The library's path for ``source``: ``libgclt_<stem>-<hash>.so``,
    the hash over the source text, the text of the headers (``*.cuh``)
    beside it and the nvcc flags."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source),
                                            "*.cuh")))
    for path in [source] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(_BUILD, f"libgclt_{stem}-{h.hexdigest()[:8]}.so")


def build(*sources: str) -> Tuple[str, ...]:
    """Compile every source whose library does not exist yet, one nvcc per
    source, all started together; returns the library paths in order.
    Raises with nvcc's output if any compile fails."""
    paths = tuple(lib_path(s) for s in sources)
    jobs = []
    for src, path in zip(sources, paths):
        if os.path.exists(path):
            continue
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((cmd, proc, tmp, path))
    failures = []
    for cmd, proc, tmp, path in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{out}\n{err}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(source: str, signatures: Signatures) -> ctypes.CDLL:
    """The bound library of ``source`` (built at first use)."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(build(source)[0])
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _loaded[source] = lib
    return lib


def edited_copy(workdir: str, name: str, text: str,
                edits: Sequence[Tuple[str, str, int]],
                headers: str = CSRC) -> str:
    """Write ``text`` as ``workdir/name/name.cu`` beside copies of the
    headers (``*.cuh``) in the directory ``headers`` (an earlier tree's
    ``csrc/``, say), or the package's where it holds none, with each edit
    ``(old, new, n)`` applied to the source and the headers together;
    returns the source's path.  Raises unless ``old`` occurs exactly ``n``
    times over all of them, so that a kernel change that moves an anchor
    fails loudly."""
    files = {f"{name}.cu": text}
    found = sorted(glob.glob(os.path.join(headers, "*.cuh")))
    for header in found or sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(header) as f:
            files[os.path.basename(header)] = f.read()
    for old, new, n in edits:
        found = sum(t.count(old) for t in files.values())
        if found != n:
            raise RuntimeError(f"{name}: {old!r} found {found} times, "
                               f"not {n}")
        files = {k: t.replace(old, new) for k, t in files.items()}
    vdir = os.path.join(workdir, name)
    os.makedirs(vdir, exist_ok=True)
    for fname, t in files.items():
        with open(os.path.join(vdir, fname), "w") as f:
            f.write(t)
    return os.path.join(vdir, f"{name}.cu")
