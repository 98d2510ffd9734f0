from repro_torch.data.partition import (
    dirichlet_partition,
    iid_partition,
    partition,
    pathological_partition,
)
from repro_torch.data.pipeline import ClientData, make_clients
from repro_torch.data.synthetic import Dataset, make_image_dataset, make_task

__all__ = [
    "ClientData", "Dataset", "dirichlet_partition", "iid_partition",
    "make_clients", "make_image_dataset", "make_task", "partition",
    "pathological_partition",
]
