"""Minimal ctypes inotify(7) binding.

The reference uses fsnotify for device-node and kubelet-socket watching
(``generic_device_plugin.go:389-457``). This is the same kernel facility bound
directly via libc — no third-party watcher dependency. A polling fallback in
:mod:`..plugin.health` covers filesystems where inotify is unavailable.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import select
import struct
from dataclasses import dataclass

IN_CREATE = 0x00000100
IN_DELETE = 0x00000200
IN_DELETE_SELF = 0x00000400
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_ATTRIB = 0x00000004
IN_IGNORED = 0x00008000

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len

_libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)


@dataclass(frozen=True)
class Event:
    wd: int
    mask: int
    name: str  # entry name within the watched dir ("" for dir-level events)


class Inotify:
    """An inotify instance watching one or more directories."""

    def __init__(self) -> None:
        fd = _libc.inotify_init1(os.O_NONBLOCK | os.O_CLOEXEC)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._fd = fd
        self._paths: dict[int, str] = {}

    @property
    def fd(self) -> int:
        return self._fd

    def add_watch(
        self,
        path: str,
        mask: int = IN_CREATE | IN_DELETE | IN_MOVED_FROM | IN_MOVED_TO | IN_DELETE_SELF,
    ) -> int:
        wd = _libc.inotify_add_watch(self._fd, path.encode(), mask)
        if wd < 0:
            raise OSError(ctypes.get_errno(), f"inotify_add_watch({path}) failed")
        self._paths[wd] = path
        return wd

    def watch_path(self, wd: int) -> str | None:
        return self._paths.get(wd)

    def read_events(self, timeout: float | None = None) -> list[Event]:
        """Drain pending events, waiting up to ``timeout`` seconds for the first."""
        ready, _, _ = select.select([self._fd], [], [], timeout)
        if not ready:
            return []
        events: list[Event] = []
        while True:
            try:
                data = os.read(self._fd, 65536)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                raise
            if not data:
                break
            off = 0
            while off + _EVENT_HDR.size <= len(data):
                wd, mask, _cookie, name_len = _EVENT_HDR.unpack_from(data, off)
                off += _EVENT_HDR.size
                raw = data[off : off + name_len]
                off += name_len
                events.append(Event(wd=wd, mask=mask, name=raw.split(b"\0", 1)[0].decode()))
            # another non-blocking read to fully drain
        return events

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass
