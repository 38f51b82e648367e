"""CmdSerializer SPI: pluggable command/result serialization.

The reference ships typed commands over Kryo with a pluggable serializer
(command/RaftStub.java:23 ``Command<R>``; support/serial/
CmdSerializer.java:11-24; support/serial/Serialization.java) — any
Java-serializable command and result travels.  Here commands are bytes on
the wire by design (the engine never inspects them), so the SPI governs
the two client-visible edges:

* ``encode_command``: what a stub accepts in ``submit``/``execute``;
* ``encode_result`` / ``decode_result``: how a machine's apply result
  crosses the leader-forward relay (a follower stub relaying to the
  leader gets the result over TCP, transport/codec.py FWD_RESP).

Default is :class:`JsonSerializer` (the r1-r3 behavior, JSON-only
results); :class:`RawSerializer` passes bytes through untouched, so a
machine returning raw bytes works across the relay — the contract the
reference's Kryo tier provides for arbitrary objects.  Plug via
``RaftFactory.serializer`` or per-node ``RaftNode(serializer=...)``.
"""

from __future__ import annotations

import json
from typing import Any, Protocol, Union, runtime_checkable


@runtime_checkable
class CmdSerializer(Protocol):
    def encode_command(self, command: Any) -> bytes: ...

    def encode_result(self, result: Any) -> bytes: ...

    def decode_result(self, data: bytes) -> Any: ...


class JsonSerializer:
    """Default: str/bytes commands pass through; results cross the relay
    as JSON (so only JSON-serializable apply results survive forwarding
    — the documented limitation this SPI exists to lift)."""

    def encode_command(self, command: Union[bytes, str]) -> bytes:
        if isinstance(command, str):
            return command.encode("utf-8")
        if isinstance(command, (bytes, bytearray, memoryview)):
            return bytes(command)
        return json.dumps(command).encode("utf-8")

    def encode_result(self, result: Any) -> bytes:
        return json.dumps(result).encode("utf-8")

    def decode_result(self, data: bytes) -> Any:
        return json.loads(data)


class RawSerializer:
    """Bytes-passthrough: commands must be bytes-like (str is utf-8
    encoded), apply results must be bytes-like and arrive as bytes."""

    def encode_command(self, command: Union[bytes, str]) -> bytes:
        if isinstance(command, str):
            return command.encode("utf-8")
        return bytes(command)

    def encode_result(self, result: Any) -> bytes:
        if result is None:
            return b""
        return bytes(result)

    def decode_result(self, data: bytes) -> Any:
        return data
