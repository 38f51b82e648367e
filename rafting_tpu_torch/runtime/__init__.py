"""Node runtime: the host half of the framework.

``RaftNode`` glues the device engine to the durable log tier, state-machine
dispatcher, snapshot archive and transport endpoint, enforcing the
persist-before-send durability barrier each tick."""

from ..api.anomaly import NotLeaderError
from .node import RaftNode
from .obsrv import ObservabilityServer

__all__ = ["RaftNode", "NotLeaderError", "ObservabilityServer"]
