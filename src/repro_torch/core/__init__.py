"""Core of the port: topologies, consensus mixing, optimizers, the step engine
and the stacked-simulation trainer (see :mod:`repro.core` for the reference).
"""

from repro_torch.core.topology import (
    Topology,
    TopologySchedule,
    make_topology,
    make_topology_schedule,
)
from repro_torch.core.engine import StepProgram
from repro_torch.core.optim import (
    CDSGD,
    CDMSGD,
    CDAdam,
    CDMSGDNesterov,
    CentralizedMSGD,
    CentralizedSGD,
    CommOps,
    FedAvg,
    GossipSGD,
    TimeVaryingCDSGD,
    make_optimizer,
    stacked_comm_ops,
)
from repro_torch.core import schedules

__all__ = [
    "Topology",
    "TopologySchedule",
    "make_topology",
    "make_topology_schedule",
    "StepProgram",
    "CDSGD",
    "CDMSGD",
    "CDMSGDNesterov",
    "CDAdam",
    "CentralizedSGD",
    "CentralizedMSGD",
    "FedAvg",
    "GossipSGD",
    "TimeVaryingCDSGD",
    "CommOps",
    "make_optimizer",
    "stacked_comm_ops",
    "schedules",
]
