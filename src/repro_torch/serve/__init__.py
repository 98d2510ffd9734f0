"""Fleet serving: many clients' personalized classifiers behind one
forward per request batch (see ``repro_torch.serve.fleet``)."""
from repro_torch.serve.fleet import FleetClassifier, FleetParams, loop_classify

__all__ = ["FleetClassifier", "FleetParams", "loop_classify"]
