"""Fleet serving: many clients' personalized models behind one call a
step, LMs and classifiers (see ``repro_torch.serve.fleet``)."""
from repro_torch.serve.fleet import (
    FleetClassifier, FleetDecoder, FleetParams, fleet_prefill_and_decode,
    loop_classify, loop_prefill_and_decode,
)

__all__ = ["FleetClassifier", "FleetDecoder", "FleetParams",
           "fleet_prefill_and_decode", "loop_classify",
           "loop_prefill_and_decode"]
