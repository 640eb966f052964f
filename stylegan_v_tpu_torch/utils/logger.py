"""stdout/stderr tee to log.txt (reference dnnlib.util.Logger, util.py:59-115); a copy of
stylegan_v_tpu/utils/logger.py."""
from __future__ import annotations

import sys
from typing import Optional


class Logger:
    """Tees writes to stdout AND a file; install() redirects sys.stdout."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "w",
                 should_flush: bool = True):
        self.file = open(file_name, file_mode) if file_name is not None else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr

    def install(self) -> "Logger":
        sys.stdout = self
        sys.stderr = self
        return self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None

    def isatty(self) -> bool:
        return False
