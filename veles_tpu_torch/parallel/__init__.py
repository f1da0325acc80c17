"""Parallelism — the port of ``veles_tpu/parallel/``: meshes, sharding
conventions, collectives, the GPipe pipeline, process gangs and the
elastic coordinator.

A JAX mesh is one program run SPMD over the devices of a process, with
XLA inserting the collectives.  Here a :class:`~veles_tpu_torch.parallel.
mesh.Mesh` is a grid of **positions**, each bound to a ``torch.device``,
and one Python controller drives every position in turn; the
collectives (:mod:`~veles_tpu_torch.parallel.collectives`) are explicit
and sum in fixed position order, so every position gets the identical
result and a run repeats bit for bit.  Positions may share a device
(:func:`~veles_tpu_torch.parallel.mesh.set_positions_per_device`): the
tests build 8-position meshes on the CPU, as the JAX tests build them on
8 virtual CPU devices.

Modules:

- :mod:`veles_tpu_torch.parallel.mesh` — positions, axis conventions;
- :mod:`veles_tpu_torch.parallel.sharding` — specs for dp/fsdp/tp/ep/sp
  and the placement of a tensor onto positions by a spec;
- :mod:`veles_tpu_torch.parallel.collectives` — psum, all-gather,
  reduce-scatter, ppermute, pmax over per-position tensors;
- :mod:`veles_tpu_torch.parallel.pipeline` — the GPipe schedule;
- :mod:`veles_tpu_torch.parallel.multihost` — a gang of processes over
  ``torch.distributed``, whose global mesh spans every process's
  positions (each process runs its own; the collectives exchange the
  others' tensors), and point-to-point transfers between two processes;
- :mod:`veles_tpu_torch.parallel.p2p` — the differentiable hop of a
  tensor from one process's position to another's (pipeline stages, sp
  rings and ep slices across processes);
- :mod:`veles_tpu_torch.parallel.coordinator` — the elastic
  master/worker job queue of the launcher's master and worker modes.
"""

from veles_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER, Mesh, MeshConfig, build_mesh, positions_per_device,
    set_positions_per_device, single_device_mesh)
