"""RaftFactory: the pluggable wiring SPI.

The reference's abstract factory (support/RaftFactory.java:16-38) lets a
user swap the log store, state machine, context manager and cluster while
``bootstrap`` wires the products together.  Here the products are the
machine provider, the transport backend and the maintain policy; the
container calls ``build_node`` to assemble a RaftNode from them
(bootstrap analog, RaftFactory.java:30-34).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..machine.file_machine import FileMachineProvider
from ..machine.spi import MachineProvider
from ..runtime.node import RaftNode
from ..transport import TcpTransport
from .config import RaftConfig


class RaftFactory:
    """Default factory: FileMachine state machines + TCP transport.
    Subclass and override ``machine_provider`` (the reference's abstract
    ``restartMachine``, RaftFactory.java:36) or ``transport_factory``."""

    def machine_provider(self, config: RaftConfig,
                         node_id: int) -> MachineProvider:
        return FileMachineProvider(
            os.path.join(config.data_dir, "machines"))

    def log_store(self, config: RaftConfig, node_id: int):
        """Build the durable log tier (reference RaftFactory.loadState,
        support/RaftFactory.java:18; SPI contract in log/spi.py).  Override
        to swap the storage engine — e.g. ``MemoryLogStore`` for tests or
        an alternative durability tier.  Return None to let RaftNode build
        the default WAL under its data dir."""
        return None

    def serializer(self, config: RaftConfig):
        """Build the command/result serializer (api/serial.py; reference
        CmdSerializer SPI, support/serial/CmdSerializer.java:11-24).
        Return None for the JSON default."""
        return None

    def transport_factory(self, config: RaftConfig) -> Callable:
        peers = dict(enumerate(config.node_addresses()))

        def build(node, on_slice, snapshot_provider):
            return TcpTransport(node.node_id, peers, node.cfg,
                                node.template, on_slice, snapshot_provider,
                                submit_handler=node.submit,
                                result_encoder=node.serializer.encode_result,
                                read_handler=node.read,
                                conf_node=node)
        return build

    def maintain(self, config: RaftConfig):
        return config.maintain()

    def build_node(self, config: RaftConfig,
                   initial_active: Optional[np.ndarray] = None,
                   provider_override: Optional[MachineProvider] = None,
                   device=None
                   ) -> RaftNode:
        # ``device``: where the node's engine runs (RaftNode's device=).
        node_id = config.node_id
        return RaftNode(
            config.engine_config(), node_id, config.data_dir,
            provider_override or self.machine_provider(config, node_id),
            self.transport_factory(config),
            seed=config.seed,
            maintain=self.maintain(config),
            initial_active=initial_active,
            group_queue_cap=config.group_queue_cap,
            total_queue_cap=config.total_queue_cap,
            busy_threshold=config.busy_threshold,
            store=self.log_store(config, node_id),
            serializer=self.serializer(config),
            latency_slo_s=config.latency_slo_ms / 1e3,
            device=device,
        )
