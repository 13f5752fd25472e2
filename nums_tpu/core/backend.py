"""Execution backends: where arrays live and how ops run.

The reference's ``System`` layer (``nums/core/systems/systems.py:31-249``)
dispatches one remote task per block through a scheduler. The inversion
here: an array is ONE ``jax.Array`` whose sharding places its blocks;
ops are whole-array jitted programs and XLA's SPMD partitioner plays the
scheduler. Two backends mirror the reference's serial/cluster split
(``SerialSystem`` systems.py:69-142 / ``RaySystem``+``BlockCyclicScheduler``
systems.py:145-249, schedulers.py:140-246):

- ``SerialBackend``: single device, plain jit. Testable anywhere.
- ``MeshBackend``: ``jax.sharding.Mesh`` over all (or configured) devices;
  arrays carry ``NamedSharding`` and XLA emits the collectives.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from nums_tpu.core import settings
from nums_tpu.core.grid import ArrayGrid, DeviceGrid


class Backend:
    """Common backend interface (role of SystemInterface, interfaces.py:23-70)."""

    name = None

    def init(self):
        return self

    def shutdown(self):
        pass

    @property
    def num_devices(self):
        raise NotImplementedError

    @property
    def num_cores_total(self):
        # Role of SystemInterface.num_cores_total: drives the block-shape
        # policy. Here "cores" = devices in the mesh.
        return self.num_devices

    def sharding_for_grid(self, grid: ArrayGrid):
        """Sharding for an array described by ``grid`` (None = default)."""
        raise NotImplementedError

    def physical_shape(self, shape: tuple, grid_shape: tuple = None):
        """At-rest buffer shape for a logical ``shape``.

        Backends that shard may round axes up to the mesh multiple
        (pad-and-mask: jax requires even divisibility for explicit
        shardings, so ragged axes are padded at rest and every consumer
        slices back to the logical shape — pads are never read).
        """
        del grid_shape
        return tuple(shape)

    def device_put(self, array: np.ndarray, grid: ArrayGrid = None):
        sharding = self.sharding_for_grid(grid) if grid is not None else None
        if grid is not None:
            pshape = self.physical_shape(grid.shape, grid.grid_shape)
            if pshape != tuple(array.shape):
                array = np.pad(
                    array,
                    [(0, p - s) for p, s in zip(pshape, array.shape)],
                )
        if sharding is None:
            return jax.device_put(array)
        from nums_tpu.core import multiprocess

        if multiprocess.is_multiprocess():
            # Multi-controller: jax.device_put can't target other hosts'
            # devices; each process materializes only its addressable
            # shards from the (process-local) host value.
            return jax.make_array_from_callback(
                tuple(array.shape), sharding, lambda idx: array[idx]
            )
        return jax.device_put(array, sharding)

    def device_reshard(self, data, grid: ArrayGrid):
        """Shard an already-on-device logical-shape array into the
        grid's at-rest layout WITHOUT a host round-trip (jnp.pad +
        device_put stay on device in single-process mode; the
        multi-controller path must stage through host because each
        process can only materialize its addressable shards)."""
        from nums_tpu.core import multiprocess

        if multiprocess.is_multiprocess():
            return self.device_put(np.asarray(data), grid)
        pshape = self.physical_shape(grid.shape, grid.grid_shape)
        if pshape != tuple(data.shape):
            import jax.numpy as jnp

            data = jnp.pad(
                data, [(0, p - s) for p, s in zip(pshape, data.shape)]
            )
        sharding = self.sharding_for_grid(grid)
        if sharding is None:
            return jax.device_put(data)
        return jax.device_put(data, sharding)

    def get(self, jax_array):
        from nums_tpu.core import multiprocess

        if multiprocess.is_multiprocess() and not getattr(
            jax_array, "is_fully_addressable", True
        ):
            # COLLECTIVE under multi-controller SPMD (every process
            # calls get in program order and receives the full value) —
            # the role of the reference's driver-side ray.get.
            return multiprocess.allgather_to_host(jax_array)
        return np.asarray(jax.device_get(jax_array))

    @property
    def mesh(self):
        return None


class SerialBackend(Backend):
    """Single-device backend (parity: SerialSystem, systems.py:69-142)."""

    name = "serial"

    def __init__(self, device=None):
        self._device = device

    def init(self):
        if self._device is None:
            self._device = jax.devices()[0]
        return self

    @property
    def num_devices(self):
        return 1

    def sharding_for_grid(self, grid: ArrayGrid):
        return jax.sharding.SingleDeviceSharding(self._device)


class MeshBackend(Backend):
    """SPMD backend over a device mesh.

    Replaces the reference's BlockCyclicScheduler placement
    (schedulers.py:140-246): array axis ``k`` is sharded over mesh axis
    ``m{k}`` when it is large enough to split; placement of each block is
    thus a static function of its grid entry, and cross-device movement is
    emitted by XLA as device collectives instead of object-store transfers.
    """

    name = "mesh"

    def __init__(self, cluster_shape: tuple = None, devices=None):
        self._cluster_shape = cluster_shape
        self._devices = devices
        self._mesh = None
        self.device_grid = None

    def init(self):
        devices = self._devices if self._devices is not None else jax.devices()
        n = len(devices)
        cluster_shape = self._cluster_shape or settings.cluster_shape
        if not cluster_shape:
            # Default 2-D mesh: all devices on the row axis. Right for the
            # data-parallel / tall-skinny workloads that dominate the
            # reference's benchmarks; override via NUMS_TPU_CLUSTER_SHAPE.
            cluster_shape = (n, 1)
        assert int(np.prod(cluster_shape)) <= n, (
            f"mesh {cluster_shape} needs {np.prod(cluster_shape)} devices, "
            f"have {n}"
        )
        used = int(np.prod(cluster_shape))
        self.device_grid = DeviceGrid(cluster_shape)
        dev_array = np.array(devices[:used]).reshape(cluster_shape)
        self._mesh = Mesh(dev_array, self.device_grid.axis_names)
        return self

    def shutdown(self):
        self._mesh = None

    @property
    def mesh(self):
        return self._mesh

    @property
    def num_devices(self):
        return self.device_grid.num_devices

    @property
    def cluster_shape(self):
        return self.device_grid.mesh_shape

    def _axis_plan(self, shape: tuple, grid_shape: tuple = None):
        """Per-axis plan: list of (physical_dim, mesh_axis_name_or_None).

        Axis ``k`` of the array maps to mesh axis ``m{k}`` when the array is
        at least as long as the mesh on that axis (so no device holds only
        padding); otherwise the axis is replicated. ``grid_shape`` (when
        given) adds the block-level hint: a single-block axis stays
        replicated, matching the reference's placement of an unsplit axis on
        one node. With pad_shard (default), mesh-indivisible axes are
        rounded up to the mesh multiple (the reference's ragged grids,
        storage.py:36-52, become pad-and-mask under uniform shards);
        without it they are replicated.
        """
        pad = settings.pad_shard

        def fit(dim, m):
            # Can axis of length `dim` shard over a mesh axis of size `m`?
            # Returns the physical (possibly padded) length, or None.
            if m <= 1 or dim < m:
                return None
            if dim % m == 0:
                return dim
            return -(-dim // m) * m if pad else None

        mesh_shape = self.device_grid.mesh_shape
        # 1-D arrays: shard over the FULL flattened mesh when possible
        # (sharding only over m0 would idle the other mesh axes).
        if len(shape) == 1:
            dim = shape[0]
            hint_ok = grid_shape is None or grid_shape[0] > 1
            if hint_ok:
                p = fit(dim, self.device_grid.num_devices)
                if p is not None:
                    return [(p, self.device_grid.axis_names)]
                p = fit(dim, mesh_shape[0] if mesh_shape else 1)
                if p is not None:
                    return [(p, self.device_grid.axis_names[0])]
            return [(dim, None)]
        plan = []
        for k, dim in enumerate(shape):
            hint_ok = grid_shape is None or grid_shape[k] > 1
            p = (
                fit(dim, mesh_shape[k])
                if k < len(mesh_shape) and hint_ok
                else None
            )
            if p is None:
                plan.append((dim, None))
            else:
                plan.append((p, self.device_grid.axis_names[k]))
        return plan

    def spec_for_shape(self, shape: tuple, grid_shape: tuple = None):
        """PartitionSpec for a shape (same decision for logical/physical)."""
        return PartitionSpec(
            *[ax for _, ax in self._axis_plan(shape, grid_shape)]
        )

    def physical_shape(self, shape: tuple, grid_shape: tuple = None):
        if len(shape) == 0:
            return ()
        return tuple(p for p, _ in self._axis_plan(shape, grid_shape))

    def sharding_for_grid(self, grid: ArrayGrid):
        if grid is None or len(grid.shape) == 0:
            return NamedSharding(self._mesh, PartitionSpec())
        return NamedSharding(
            self._mesh, self.spec_for_shape(grid.shape, grid.grid_shape)
        )

    def sharding_for_shape(self, shape: tuple, grid_shape: tuple = None):
        if len(shape) == 0:
            return NamedSharding(self._mesh, PartitionSpec())
        return NamedSharding(self._mesh, self.spec_for_shape(shape, grid_shape))

    def replicated_sharding(self):
        return NamedSharding(self._mesh, PartitionSpec())


_BACKENDS = {
    "serial": SerialBackend,
    "mesh": MeshBackend,
}


def make_backend(name: str = None, **kwargs) -> Backend:
    name = name or settings.backend_name
    if name not in _BACKENDS:
        raise ValueError(
            f"Unknown backend {name!r}; expected one of {sorted(_BACKENDS)}"
        )
    return _BACKENDS[name](**kwargs).init()
