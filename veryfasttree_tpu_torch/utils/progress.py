# Copy of veryfasttree_tpu/utils/progress.py (the port imports none of it).
"""Progress reporting and log tee-ing (ref src/Utils.h:52-77, 183-230)."""
from __future__ import annotations

import sys
import time


class ProgressReport:
    """Timed, throttled progress lines on stderr.

    Mirrors the reference ProgressReport: prints at most ~once/second, prefixes
    elapsed wall-clock (or deltas with relative_progress), pads/erases the line
    when on a TTY.
    """

    def __init__(self, show_progress: bool = True, verbose: int = 1,
                 relative: bool = False, stream=None):
        self.show = show_progress and verbose > 0
        self.relative = relative
        self.stream = stream if stream is not None else sys.stderr
        self.t0 = time.time()
        self.last_print = 0.0
        self.last_line_len = 0
        self.is_tty = hasattr(self.stream, "isatty") and self.stream.isatty()

    def clock_diff(self) -> float:
        return time.time() - self.t0

    def print(self, fmt: str, *args) -> None:
        if not self.show:
            return
        now = time.time()
        if now - self.last_print < 1.0:
            return
        msg = (fmt % args) if args else fmt
        if self.relative:
            stamp = f"+{now - max(self.last_print, self.t0):9.2f} seconds: "
        else:
            stamp = f"{now - self.t0:11.2f} seconds: "
        self.last_print = now
        line = stamp + msg
        if self.is_tty:
            pad = " " * max(0, self.last_line_len - len(line))
            self.stream.write("\r" + line + pad)
            self.stream.flush()
            self.last_line_len = len(line)
        else:
            self.stream.write(line + "\n")

    def done(self) -> None:
        if self.show and self.is_tty and self.last_line_len:
            self.stream.write("\n")
            self.last_line_len = 0


class TeeStream:
    """Write-through to several streams (log file + stderr), ref TeeStream."""

    def __init__(self, *streams):
        self.streams = [s for s in streams if s is not None]

    def write(self, data):
        for s in self.streams:
            s.write(data)
        return len(data)

    def flush(self):
        for s in self.streams:
            s.flush()

    def isatty(self):
        return False
