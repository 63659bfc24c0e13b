"""Build helpers for the native libraries (C++ SBVH builder, CUDA kernel).

Libraries are compiled from the tracked sources into ``<checkout>/build/``
(listed in .gitignore) on first use.  Each output name carries a hash of
the source and the compile command, so an edited source or flag never
loads a stale library.  A build writes to a temporary name and moves it
into place with ``os.replace``: several processes (test workers) may build
the same library at once, and each sees either no file or a whole one.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")


def library_path(stem: str, src: str, cmd_template: list[str]) -> str:
    """Content-keyed output path for `src` compiled by `cmd_template`."""
    h = hashlib.blake2b(digest_size=8)
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(cmd_template).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()}.so")


def build_library(stem: str, src: str, cmd_template: list[str],
                  timeout: float = 600.0) -> str:
    """Compile `src` unless its library exists; returns the library path.

    cmd_template: the compiler command with "{out}" where the output path
    goes.  Raises RuntimeError with the compiler's message on failure."""
    out = library_path(stem, src, cmd_template)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{stem}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [tmp if a == "{out}" else a for a in cmd_template]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{cmd[0]} failed to run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
