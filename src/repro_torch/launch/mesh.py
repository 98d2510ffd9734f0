"""The FL simulator's sim mesh (the port's twin of the JAX package's
``launch/mesh.py``, its host helpers).

The batched engine stacks a visit group's concurrent client visits along a
leading ``(C, ...)`` lane axis; under ``FLConfig.engine="sharded"`` (or
``mesh_data_axis``) that axis is laid out on a 1-D mesh of devices, and
every cohort is ghost-padded to a multiple of the mesh size
(``round_up_to_mesh``): ghost lanes never train, never draw RNG and weigh 0
in the reduce. The fused engine's data plane pads its shards to the
largest one and its rows to a mesh multiple (``data.pipeline``).

The port's mesh is a small object, ``SimMesh``: its devices, its one axis
name and ``shape[axis]``. ``make_sim_mesh`` builds it over the devices
``visible_devices`` lists for the trainer's device: every visible card for
CUDA, the one CPU for the CPU. A mesh whose entries are all one device
places every lane stack where it already is, so the engines run the
unmeshed arithmetic on the padded shapes. A test sets the mesh size by
replacing ``visible_devices`` (e.g. with ``[device] * 8``). A split of the
lane axis across several distinct devices is ROADMAP A5.2 and raises.

The LM trainer's host mesh (``make_host_mesh``, ``HostMesh``) lays the
visible devices out as (data, model) with ``_host_mesh_shape``, as the
reference does; the trainer stacks ``shape["data"]`` client lanes. A host
mesh over several distinct devices raises (ROADMAP A5.2). The reference's
production mesh (``make_production_mesh``) is TPU-pod tooling, ROADMAP A11.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SimMesh:
    """A 1-D device mesh: ``devices`` along the one axis ``axis``;
    ``shape[axis]`` is its size, as a ``jax.sharding.Mesh``'s is."""

    devices: Tuple[torch.device, ...]
    axis: str = "data"

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}


def round_up_to_mesh(n: int, mesh) -> int:
    """Smallest multiple of ``mesh``'s axis size >= ``n`` — the ghost-
    padding target shared by the sharded/fused engines' cohort axis and the
    fused engine's device-resident fleet stack."""
    size = mesh.shape[mesh.axis]
    return -(-n // size) * size


def visible_devices(device=None) -> List[torch.device]:
    """The devices a sim mesh for ``device`` may span: every visible CUDA
    card for a CUDA device (the default), the one CPU for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_sim_mesh(num_clients: Optional[int] = None, *, axis: str = "data",
                  device=None) -> SimMesh:
    """1-D device mesh for the FL simulator's stacked client axis, over
    ``visible_devices(device)``. ``num_clients`` caps the mesh at the fleet
    size so no device is left without at least one client row; cohorts
    smaller than the mesh, or not divisible by it, are ghost-padded by the
    engine. Raises ``NotImplementedError`` when the mesh would span more
    than one distinct device (ROADMAP A5.2)."""
    devices = [torch.device(d) for d in visible_devices(device)]
    n = len(devices)
    if num_clients is not None:
        n = max(1, min(n, num_clients))
    devices = devices[:n]
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"a sim mesh over {len(set(devices))} distinct devices "
            f"({', '.join(str(d) for d in dict.fromkeys(devices))}) would "
            "split the lane axis across cards, which is not ported yet "
            "(ROADMAP A5.2); make only one device visible")
    return SimMesh(tuple(devices), axis)


def _host_mesh_shape(n: int) -> Tuple[int, int]:
    """(data, model) factorization of ``n`` host devices that strands none:
    model=2 only when it divides evenly (4 -> (2,2), 8 -> (4,2)); odd or
    tiny counts keep every device on "data" (5 -> (5,1), 2 -> (2,1))."""
    model = 2 if (n >= 4 and n % 2 == 0) else 1
    return (n // model, model)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A 2-D (data, model) layout of ``devices``, ``_host_mesh_shape`` of
    their count; ``shape`` reads as a ``jax.sharding.Mesh``'s does."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, _host_mesh_shape(len(self.devices))))


def make_host_mesh(device=None) -> HostMesh:
    """Whatever fits the host (the twin of the reference's
    ``make_host_mesh``): every device ``visible_devices(device)`` lists,
    odd counts included; one device gives (1, 1). Only the "data" size
    means something here: the LM trainer stacks that many client lanes.
    The reference shards each client's model over "model" (tensor
    parallelism inside one participant); on one card every lane's model
    runs whole, so the "model" size sets nothing. Raises
    ``NotImplementedError`` when the list holds more than one distinct
    device (ROADMAP A5.2)."""
    devices = tuple(torch.device(d) for d in visible_devices(device))
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"a host mesh over {len(set(devices))} distinct devices "
            f"({', '.join(str(d) for d in dict.fromkeys(devices))}) would "
            "split the client stack across cards, which is not ported yet "
            "(ROADMAP A5.2); make only one device visible")
    return HostMesh(devices)


def check_lane_axis(mesh, C: int, what: str, device: torch.device) -> None:
    """The placement contract of a lane-stacked call under ``mesh``: ``C``
    must be a multiple of the mesh axis (``what`` names the axis in the
    reference's words), and every mesh entry must be ``device``, where the
    lane stacks already live (a split across devices is ROADMAP A5.2)."""
    data_axis = mesh.axis
    n_shards = mesh.shape[data_axis]
    if C % n_shards != 0:
        if what == "schedule":
            raise ValueError(
                f"schedule lane axis C={C} must be a multiple of mesh "
                f"axis {data_axis!r}={n_shards}")
        raise ValueError(
            f"client axis C={C} must be a multiple of mesh axis "
            f"{data_axis!r}={n_shards}; ghost-pad the cohort "
            "(stack_plans/stack_plan_indices pad_to=...)")
    devices = getattr(mesh, "devices", ())
    if not all(_same(d, device) for d in devices):
        raise NotImplementedError(
            f"mesh entries {sorted({str(d) for d in devices})} are not the "
            f"trainer's device {device}: placing lanes across devices is "
            "not ported yet (ROADMAP A5.2)")


def _same(a, b) -> bool:
    """Whether two devices are one: a bare ``cuda`` is the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index is None or b.index is None:
        return True
    return a.index == b.index
