"""State-machine SPI and the apply dispatcher of the port.  The KV
machine of ``rafting_tpu.machine`` is not ported yet."""

from .spi import Checkpoint, MachineProvider, RaftMachine  # noqa: F401
from .file_machine import FileMachine, FileMachineProvider  # noqa: F401
from .dispatch import ApplyDispatcher  # noqa: F401
