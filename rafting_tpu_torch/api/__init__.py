"""Public API layer of the port: so far the error taxonomy and the
command serializers the node runtime needs (``rafting_tpu.api``'s
``anomaly`` and ``serial``).  The container, stub, factory, config and
retry modules are not ported yet."""

from .anomaly import (
    BusyLoopError, NotLeaderError, NotReadyError, ObsoleteContextError,
    OverloadError, RaftError, RetryCommandError, SerializeError,
    StorageFaultError, UnavailableError, WaitTimeoutError, retry_after_of,
)
from .serial import CmdSerializer, JsonSerializer, RawSerializer

__all__ = [
    "CmdSerializer", "JsonSerializer", "RawSerializer",
    "RaftError", "NotLeaderError", "NotReadyError", "BusyLoopError",
    "OverloadError", "UnavailableError", "ObsoleteContextError",
    "WaitTimeoutError", "RetryCommandError", "SerializeError",
    "StorageFaultError", "retry_after_of",
]
