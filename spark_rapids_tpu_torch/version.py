"""Build and version stamp of the PyTorch port.

Counterpart of `spark_rapids_tpu/version.py` (the reference's
build/build-info, which writes version-info.properties into the jar,
pom.xml:467-492). The same six fields: version, user, revision, branch,
date, url. Host only.
"""
from __future__ import annotations

import datetime
import functools
import os
import subprocess

__version__ = "0.1.0"


def _git(*args: str) -> str:
    """A git query in the checkout around the package; '' outside one."""
    try:
        out = subprocess.run(["git", *args], capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))), timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


@functools.lru_cache(None)
def version_info() -> dict:
    """The version-info.properties equivalent, computed once a process."""
    return {
        "version": __version__,
        "user": os.environ.get("USER", ""),
        "revision": _git("rev-parse", "HEAD"),
        "branch": _git("rev-parse", "--abbrev-ref", "HEAD"),
        "date": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "url": _git("config", "--get", "remote.origin.url"),
    }
