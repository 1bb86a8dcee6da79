"""In-process span recorder of the port: the stages of DeviceVO's frame on
the host's clock.

    from dpvo_torch import tracing
    tracing.enable()
    vo(t, image, intrinsics)            # records vo.frame, vo.step, ...
    records = tracing.drain()           # [Record], and the list cleared
    tracing.disable()

Off by default. While off, `span` returns one shared object whose enter
and exit do nothing, and `frame` does nothing: the cost is one test of the
switch per call. While on, each span appends a Record to one in-memory
list; nothing is written out during a run.

Times are `time.monotonic_ns()`, CLOCK_MONOTONIC: the clock a benchmark
notes beside the marks that map its device trace onto the host's clock, so
that the same offset places these spans on the trace. A span's parent is
the span open on the same thread when it starts (a stack per thread:
several threads may each drive a DeviceVO). `frame(frame_id)` sets the
identifier that the thread's following spans carry: DeviceVO uses the
frame's input index on the host.

A span launches no device work, records no CUDA event, reads nothing back
and changes no tensor: it times what the host spends between two points,
and a device trace gives the device work launched in between.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple


class Record(NamedTuple):
    name: str
    frame: int | None      # the identifier `frame` set on this thread
    parent: int | None     # index of the enclosing span in the same drain
    thread: int            # threading.get_ident()
    t0_ns: int             # time.monotonic_ns() at entry
    t1_ns: int | None      # at exit; None while the span is open
    attrs: dict


_on = False
_records = []              # [list], one per span, made Records by drain()


class _Thread(threading.local):
    """Per thread: [stack of open span lists, frame identifier, id]."""

    def __init__(self):
        self.state = [[], None, threading.get_ident()]


_thread = _Thread()


class _Off:
    """The span handed out while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('name', 'attrs', 'rec', 'stack')

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack, frame_id, tid = _thread.state
        # the parent is held as its list until drain() numbers them
        self.rec = rec = [self.name, frame_id, stack[-1] if stack else None,
                          tid, 0, None, self.attrs]
        self.stack = stack
        _records.append(rec)
        stack.append(rec)
        rec[4] = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self.rec[5] = time.monotonic_ns()
        self.stack.pop()
        return False


def span(name, **attrs):
    """Context manager timing the block as span `name` with `attrs`."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def frame(frame_id):
    """Tag this thread's following spans with `frame_id`."""
    if _on:
        _thread.state[1] = frame_id


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def drain():
    """The Records so far, in the order their spans started, taken off
    the list. Parents index into the returned list; a parent drained
    before is None. A span still open is returned with t1_ns None, and its
    end is lost: drain between frames."""
    out = _records[:]
    del _records[:len(out)]      # spans started meanwhile stay
    index = {id(r): i for i, r in enumerate(out)}
    return [Record(r[0], r[1], None if r[2] is None else index.get(id(r[2])),
                   *r[3:]) for r in out]
