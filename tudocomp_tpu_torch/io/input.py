"""Input source abstraction (the ``Input`` of ``tudocomp_tpu/io/input.py``,
copied; the port has no use for its ``Output`` yet).

Reference counterparts: ``io/Input.hpp:37-251`` (memory view / file /
istream sources with lazy slicing), ``io/MMapHandle.hpp`` (mmap-backed
file views). Pythonic re-design: ``Input`` wraps bytes / a file path
(mmap-backed, ``MADV_SEQUENTIAL`` where available) / a binary stream,
offers ``as_view()`` (zero-copy random access) and ``as_stream()``
(one-pass reader), and supports ``Input(other, from_, to)`` slicing like
the reference's slice constructor.
"""

from __future__ import annotations

import io as _io
import mmap
import os
from typing import Optional, Union


class Input:
    def __init__(self, source: Union[bytes, bytearray, str, os.PathLike,
                                     _io.RawIOBase, "Input"],
                 from_: int = 0, to: Optional[int] = None):
        if isinstance(source, Input):
            view = source.as_view()
            self._data = view[from_: to if to is not None else len(view)]
            self._mmap = None
            return
        self._mmap = None
        if isinstance(source, (bytes, bytearray, memoryview)):
            data = memoryview(source)
        elif isinstance(source, (str, os.PathLike)):
            f = open(source, "rb")
            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                if hasattr(mm, "madvise"):
                    try:
                        mm.madvise(mmap.MADV_SEQUENTIAL)
                    except Exception:
                        pass
                self._mmap = mm
                data = memoryview(mm)
            except ValueError:  # empty file cannot be mmapped
                data = memoryview(f.read())
            finally:
                f.close()
        elif hasattr(source, "read"):
            data = memoryview(source.read())
        else:
            raise TypeError(f"unsupported input source: {type(source)}")
        end = to if to is not None else len(data)
        self._data = data[from_:end]

    def __len__(self) -> int:
        return len(self._data)

    def as_view(self) -> memoryview:
        """Zero-copy random-access view (reference ``as_view``)."""
        return self._data

    def as_bytes(self) -> bytes:
        return bytes(self._data)

    def as_stream(self) -> _io.BytesIO:
        """One-pass reader (reference ``as_stream``)."""
        return _io.BytesIO(self._data)

    def close(self) -> None:
        self._data = memoryview(b"")
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # a view from as_view() or a slice Input is still
                # alive; leave the mmap for GC instead of raising and
                # half-closing (the reference's InputAlloc pools
                # allocations for the same reason)
                return
            self._mmap = None

