"""Test kit of the PyTorch port: the scalar oracle and its lockstep
runner, nemesis schedules, invariant audits (the transfer atomicity
judgment included), the chaos conductor, storage faults and open-loop
traffic."""

from .oracle import oracle_step  # noqa: F401
from .invariants import (  # noqa: F401
    ClusterChecker, check_transfer_atomicity, cluster_snapshot,
)
from . import nemesis  # noqa: F401
from . import faultfs  # noqa: F401
from . import openloop  # noqa: F401
