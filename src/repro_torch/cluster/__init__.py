"""Serving engines of the port: the request API, the streaming
:class:`DecodeEngine` and the continuously-batched
:class:`PagedDecodeEngine`."""

from repro_torch.cluster.api import (  # noqa: F401
    Completion,
    QueueFullError,
    Request,
)
from repro_torch.cluster.decode import DecodeEngine, DecodeResult  # noqa: F401
from repro_torch.cluster.paged import PageAllocator, PagedDecodeEngine  # noqa: F401
