"""State-machine SPI and the apply dispatcher.

The user plug-point of the framework: a :class:`RaftMachine` per group
applies committed commands and supports checkpoint/recover — the contract
of the reference's RaftMachine interface (curioloop/rafting
command/RaftMachine.java:12-63) and MachineProvider SPI
(command/spi/MachineProvider.java:9-13).  The :class:`ApplyDispatcher`
consumes the device commit frontier and drives machines in log order —
the vectorized analog of RaftRoutine.commitState/applyEntry/applyCommand
(context/RaftRoutine.java:224-306).
"""

from .spi import Checkpoint, MachineProvider, RaftMachine  # noqa: F401
from .file_machine import FileMachine, FileMachineProvider  # noqa: F401
from .kv_machine import KVMachine, KVMachineProvider  # noqa: F401
from .dispatch import ApplyDispatcher  # noqa: F401
