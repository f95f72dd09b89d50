"""Native (C++) runtime components, bound via ctypes.

Each is built at first use with the system C++ compiler (`g++ -O2
-std=c++17`, or `$CXX`) into the repository's gitignored
`.torch_ext_build/`, one shared library per source hash, as the CUDA
kernels are (`ops/tnt_kernels.load_library`); nothing is built beside the
source. A failed build raises `NativeBuildError`.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / ".torch_ext_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or failed."""


def build_extension(name: str) -> pathlib.Path:
    """Compile `<name>.cpp` into `.torch_ext_build/<name>_<hash>.so` (once
    per source and flags) and return its path."""
    src = _DIR / f"{name}.cpp"
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join((cxx,) + CXX_FLAGS).encode())
    out = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{cxx} could not build {src.name}: {e}") \
            from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{cxx} failed ({proc.returncode}) on "
                               f"{src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
