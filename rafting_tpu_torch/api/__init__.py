"""Public API layer: container / stub / factory / config + error taxonomy
(the reference's L5, RaftContainer.java / command/RaftStub.java /
support/RaftFactory.java / support/RaftConfig.java)."""

from .anomaly import (
    BusyLoopError, NotLeaderError, NotReadyError, ObsoleteContextError,
    OverloadError, RaftError, RetryCommandError, SerializeError,
    StorageFaultError, UnavailableError, WaitTimeoutError, retry_after_of,
)
from .retry import CircuitBreaker, RetryBudget
from .config import RaftConfig, load_xml_config
from .container import ADMIN_GROUP, GroupRegistry, RaftContainer
from .factory import RaftFactory
from .serial import CmdSerializer, JsonSerializer, RawSerializer
from .stub import RaftStub

__all__ = [
    "RaftConfig", "load_xml_config", "RaftContainer", "RaftFactory",
    "RaftStub", "GroupRegistry", "ADMIN_GROUP",
    "CmdSerializer", "JsonSerializer", "RawSerializer",
    "RaftError", "NotLeaderError", "NotReadyError", "BusyLoopError",
    "OverloadError", "UnavailableError", "ObsoleteContextError",
    "WaitTimeoutError", "RetryCommandError", "SerializeError",
    "StorageFaultError", "retry_after_of",
    "RetryBudget", "CircuitBreaker",
]
