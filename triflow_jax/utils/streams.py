"""Minimal push-based stream implementation.

The reference wires its observability spine with the external ``streamz``
library (upstream triflow/core/simulation.py:184,252 and
plugins/container.py:99-123).  That dependency is not needed for the small
subset actually used — ``Stream``, ``map``, ``sink``, ``partition`` and
``collect`` — so this module provides a self-contained implementation with
the same call surface.
"""

from __future__ import annotations

from typing import Callable, List


class Stream:
    """Push-based event stream: ``emit`` propagates a value to every
    downstream node."""

    def __init__(self, upstream: "Stream" = None):
        self.downstreams: List[Stream] = []
        self.upstream = upstream
        if upstream is not None:
            upstream.downstreams.append(self)

    # -- construction -------------------------------------------------------
    def map(self, func: Callable, *args, **kwargs) -> "Stream":
        return _Map(self, func, *args, **kwargs)

    def sink(self, func: Callable) -> "Stream":
        return _Sink(self, func)

    def partition(self, n: int) -> "Stream":
        return _Partition(self, n)

    def filter(self, predicate: Callable) -> "Stream":
        return _Filter(self, predicate)

    # -- propagation --------------------------------------------------------
    def emit(self, value):
        self._update(value)

    def _update(self, value):
        self._push(value)

    def _push(self, value):
        for node in list(self.downstreams):
            node._update(value)

    def disconnect(self):
        if self.upstream is not None and self in self.upstream.downstreams:
            self.upstream.downstreams.remove(self)


class _Map(Stream):
    def __init__(self, upstream, func, *args, **kwargs):
        super().__init__(upstream)
        self._func = func
        self._args = args
        self._kwargs = kwargs

    def _update(self, value):
        self._push(self._func(value, *self._args, **self._kwargs))


class _Filter(Stream):
    def __init__(self, upstream, predicate):
        super().__init__(upstream)
        self._predicate = predicate

    def _update(self, value):
        if self._predicate(value):
            self._push(value)


class _Sink(Stream):
    def __init__(self, upstream, func):
        super().__init__(upstream)
        self._func = func

    def _update(self, value):
        self._func(value)


class _Partition(Stream):
    """Buffer n values, then emit them as a tuple."""

    def __init__(self, upstream, n):
        super().__init__(upstream)
        self._n = n
        self._buffer = []

    def _update(self, value):
        self._buffer.append(value)
        if len(self._buffer) >= self._n:
            out, self._buffer = tuple(self._buffer), []
            self._push(out)


class Collector(Stream):
    """Cache every upstream value until ``flush`` pushes the cached tuple
    downstream (streamz ``collect`` analog used by the container,
    reference container.py:119-137)."""

    def __init__(self, upstream):
        super().__init__(upstream)
        self._cache = []

    def _update(self, value):
        self._cache.append(value)

    def flush(self, *_ignored):
        out, self._cache = tuple(self._cache), []
        self._push(out)


def collect(stream: Stream) -> Collector:
    return Collector(stream)
