"""Native (C++) helpers, built from the sources in this directory into the
git-ignored ``build/`` subdirectory on first use."""

from __future__ import annotations

import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")


def build(src: str, lib: str) -> str | None:
    """Path of ``build/<lib>`` compiled from ``<src>``, rebuilt when missing
    or older than the source; None when no toolchain can build it."""
    src_path = os.path.join(_DIR, src)
    lib_path = os.path.join(BUILD_DIR, lib)
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(
        src_path
    ):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent test workers may
    # build the same library at once
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src_path],
            check=True,
            capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, lib_path)
    return lib_path
