# FedSR — ring-optimization over edge rings + semi-decentralized cloud
# aggregation. Algorithms are planners over the RoundPlan IR
# (repro_torch.core.plan); the engines package interprets the plans.
from repro_torch.core.algorithms import ALGORITHMS, make_algorithm
from repro_torch.core.comm import CommMeter
from repro_torch.core.engines import make_engine
from repro_torch.core.executor import ExperimentResult, RoundRecord, run_experiment
from repro_torch.core.local import LocalTrainer
from repro_torch.core.plan import AggSpec, RoundPlan, VisitGroup
from repro_torch.core.ring import ring_optimization

__all__ = [
    "ALGORITHMS", "AggSpec", "CommMeter", "ExperimentResult", "LocalTrainer",
    "RoundPlan", "RoundRecord", "VisitGroup", "make_algorithm",
    "make_engine", "ring_optimization", "run_experiment",
]
