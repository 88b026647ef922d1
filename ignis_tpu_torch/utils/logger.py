"""Leveled logger with pluggable listeners.

A copy of ignis_tpu/utils/logger.py (the reference Logger: leveled IG_LOG
with console-colour and file listeners). The port logs through this
instead of bare prints; frontends attach and detach listeners.
"""
from __future__ import annotations

import sys
import time
from enum import IntEnum
from typing import Callable, List, Optional, TextIO


class LogLevel(IntEnum):
    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3
    FATAL = 4


_NAMES = {LogLevel.DEBUG: "Debug", LogLevel.INFO: "Info",
          LogLevel.WARNING: "Warning", LogLevel.ERROR: "Error",
          LogLevel.FATAL: "Fatal"}
_COLORS = {LogLevel.DEBUG: "\033[90m", LogLevel.INFO: "",
           LogLevel.WARNING: "\033[33m", LogLevel.ERROR: "\033[31m",
           LogLevel.FATAL: "\033[1;31m"}
_RESET = "\033[0m"


class ConsoleLogListener:
    """Colored console sink (reference ConsoleLogListener.cpp)."""

    def __init__(self, stream: Optional[TextIO] = None, color: bool = True):
        self.stream = stream or sys.stderr
        self.color = color and getattr(self.stream, "isatty", lambda: False)()

    def __call__(self, level: LogLevel, msg: str):
        tag = f"[{_NAMES[level]}]"
        if self.color:
            self.stream.write(f"{_COLORS[level]}{tag} {msg}{_RESET}\n")
        else:
            self.stream.write(f"{tag} {msg}\n")
        self.stream.flush()


class FileLogListener:
    """Timestamped file sink (reference FileLogListener.cpp)."""

    def __init__(self, path: str):
        self._f = open(path, "a")
        self._t0 = time.time()

    def __call__(self, level: LogLevel, msg: str):
        self._f.write(f"[{time.time() - self._t0:9.3f}]"
                      f"[{_NAMES[level]}] {msg}\n")
        self._f.flush()

    def close(self):
        self._f.close()


class Logger:
    def __init__(self):
        self.verbosity = LogLevel.INFO
        self.quiet = False
        self._listeners: List[Callable[[LogLevel, str], None]] = []

    def add_listener(self, listener):
        self._listeners.append(listener)
        return listener

    def remove_listener(self, listener):
        self._listeners.remove(listener)

    def set_verbosity(self, level: LogLevel):
        self.verbosity = LogLevel(level)

    def log(self, level: LogLevel, msg: str):
        if self.quiet or level < self.verbosity:
            return
        if not self._listeners:   # lazy default console listener
            self._listeners.append(ConsoleLogListener())
        for listener in self._listeners:
            listener(level, msg)

    def debug(self, msg: str):
        self.log(LogLevel.DEBUG, msg)

    def info(self, msg: str):
        self.log(LogLevel.INFO, msg)

    def warning(self, msg: str):
        self.log(LogLevel.WARNING, msg)

    def error(self, msg: str):
        self.log(LogLevel.ERROR, msg)


#: global logger (reference IG_LOGGER singleton)
logger = Logger()
