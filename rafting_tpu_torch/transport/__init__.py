"""Host transport plane: dense tick-slice RPC between Raft nodes.

Replaces the reference's Netty stack (transport/EventBus.java,
EventNode.java, EventCodec.java, NettyNode.java) with a tick-sliced wire
protocol: everything one node says to one peer in one engine tick travels
as one sparse-packed frame (codec.py), merged at the receiver into the
dense inbox the vectorized engine consumes (inbox.py).  TCP and in-process
loopback backends share the interface (tcp.py, loopback.py)."""

from .codec import messages_template
from .faults import LinkAction, LinkFaults
from .inbox import InboxAccumulator
from .loopback import LoopbackNetwork, LoopbackTransport
from .tcp import TcpTransport

__all__ = [
    "messages_template", "InboxAccumulator",
    "LinkAction", "LinkFaults",
    "LoopbackNetwork", "LoopbackTransport", "TcpTransport",
]
