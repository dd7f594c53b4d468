"""Multi-host scaffolding for the cartesian distributed solver.

The reference scales across nodes with plain MPI ranks (SURVEY.md section 5:
`mpiexec -n <ranks>`, PETSc stash exchange + VecScatter over the
interconnect). Across hosts the network is TWO-TIER: devices within a host
talk over the host's device links (NVLink between the GPUs of one host);
hosts talk over the slower network between them. This module maps the
solver's cartesian device grid onto that hierarchy:

  - `initialize()` wraps `jax.distributed.initialize` -- the JAX runtime
    handshake that turns N independent host processes into one logical
    computation (each host sees its local chips + addressable globals).
    It is a guarded no-op in single-process runs, so the same driver
    script works on a laptop, one multi-GPU host, or several hosts.
  - `host_partition()` builds the CartPartition whose OUTERMOST grid axis
    (z in 3D -- the slowest-varying axis of the device stack,
    cart.CartPartition._stack_shape) is the host axis. Every ppermute
    halo exchange then crosses the inter-host network on at most that one
    axis (one plane-sized message per neighbor host per apply); the x/y
    halos stay inside a host. The Gram-Schmidt psum spans all axes but
    its payload is a scalar. This is the standard "outer axis across
    hosts" recipe.
  - `local_boxes()` gives each process the (ix, iy, iz) element boxes its
    OWN devices own, so per-shard setup (cart_abf.build_cart_abf's
    per-box assembly, femixedspace.c:2306-2647) can run host-locally: a
    host assembles only the element blocks of its slab of the grid.

Real multi-host execution needs several hosts; the logical path -- device
ordering, host-axis placement, per-host box ownership -- is exercised by
tests/test_multihost.py on a virtual 8-device mesh split as 2 hosts x 4
devices.
"""

import os

import numpy as np
import jax

from exsaddle_tpu.parallel.cart import CartPartition


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """Initialize JAX's multi-process runtime; no-op on a single host.

    Multi-process mode is entered when any of the arguments is given or
    the environment (JAX_COORDINATOR_ADDRESS) announces a multi-process
    topology. Returns
    (num_processes, process_id) as seen by the runtime after (possible)
    initialization.
    """
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    env = os.environ.get("JAX_COORDINATOR_ADDRESS") \
        or os.environ.get("COORDINATOR_ADDRESS")
    if explicit or env:
        jax.distributed.initialize(
            coordinator_address=coordinator_address or env,
            num_processes=num_processes, process_id=process_id)
    return jax.process_count(), jax.process_index()


def host_devices():
    """Global device list ordered host-major (process 0's chips first).

    With a real multi-host runtime this is the property that makes
    `host_partition` place each host's chips contiguously along the
    outermost mesh axis; in single-process runs it is just
    `jax.devices()`.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return devs


def host_partition(mesh, n_hosts, chips_per_host, chip_shape=None):
    """CartPartition over (n_hosts * chips_per_host) devices with the host
    axis on the OUTERMOST grid dimension.

    chip_shape: device grid per host over the remaining dims (innermost
    first), e.g. (2, 2) for 4 chips in 3D -> dev_shape (2, 2, n_hosts).
    Default: all chips along the second-outermost axis.

    The returned partition's device stack is z-major
    (CartPartition._stack_shape), so devices [h*chips_per_host :
    (h+1)*chips_per_host] of `host_devices()` land exactly on host h's
    slab -- device links inside the slab, the inter-host network only
    across slab faces.
    """
    nd = mesh.ndim
    if chip_shape is None:
        chip_shape = (1,) * (nd - 2) + (chips_per_host,)
    if int(np.prod(chip_shape)) != chips_per_host:
        raise ValueError(f"chip_shape {chip_shape} does not hold "
                         f"{chips_per_host} chips")
    dev_shape = tuple(chip_shape) + (n_hosts,)
    if len(dev_shape) != nd:
        raise ValueError(f"chip_shape must have {nd - 1} dims")
    return CartPartition(mesh, dev_shape)


class HostComm:
    """Multi-host reduction context for per-shard setup.

    Owns the process identity (which element boxes this host assembles,
    via `local_boxes`) and the cross-host summation of the additive setup
    partials -- the JAX equivalent of PETSc's MatAssemblyBegin/End
    stash exchange (femixedspace.c:2624-2625). The default implementation
    uses the jax multi-process runtime (`process_allgather` across
    hosts) and
    degenerates to the identity in single-process runs; tests inject an
    `allreduce(arr, tag)` callable to drive the same constructor path on
    a simulated multi-host topology.
    """

    def __init__(self, n_hosts=None, process_id=None, allreduce=None,
                 apply_others=None):
        self.n_hosts = jax.process_count() if n_hosts is None else n_hosts
        self.process_id = (jax.process_index() if process_id is None
                           else process_id)
        self._allreduce = allreduce
        # simulated topologies: tag -> list of the OTHER hosts' partial
        # operator closures (apply_partial_sum evaluates them in-process
        # where a real runtime would allreduce the result vector)
        self._apply_others = apply_others

    def allreduce_dense(self, arr, tag):
        """Sum a dense numpy partial across hosts. `tag` names the
        quantity (stable across hosts) so injected test reducers can match
        partials without relying on call order or array shape."""
        if self._allreduce is not None:
            return self._allreduce(arr, tag)
        if self.n_hosts == 1:
            return arr
        import jax.numpy as jnp
        from jax.experimental import multihost_utils
        gathered = multihost_utils.process_allgather(jnp.asarray(arr))
        return np.asarray(gathered).sum(axis=0)

    def apply_partial_sum(self, v, local_fn, tag):
        """Distributed y = sum_h A_h(v): evaluate THIS host's partial
        operator on v and sum the other hosts' contributions. Real leg:
        one dense allreduce of the O(nodes) RESULT vector -- the element
        data behind local_fn never crosses hosts (the stash-exchange
        economics of femixedspace.c:2624-2625). Simulated topologies
        evaluate the other hosts' injected closures in-process."""
        y = np.asarray(local_fn(v))
        if self._apply_others is not None:
            for f in self._apply_others.get(tag, ()):
                y = y + f(v)
            return y
        return self.allreduce_dense(y, tag)

    def place_shards(self, stack, tag):
        """Device-stacked per-box slabs: each process assembles and feeds
        only the slabs of its OWN addressable devices, so in a real
        multi-process runtime this is pure local placement (no
        cross-host bytes; jax.make_array_from_process_local_data consumes
        exactly
        the local shards). The generic fallback sums the disjoint slabs
        through the same channel as allreduce_dense (the per-box writes
        are disjoint, so the sum IS the placement); the separate method
        keeps the intent -- and the payload class -- distinguishable to
        callers and tests."""
        return self.allreduce_dense(stack, tag)

    def allreduce_minmax(self, bounds):
        """Reduce a [lo, hi] bracket across hosts: min over lo, max over
        hi (the p-block spectrum bracket of cart_abf; sum semantics do not
        apply). Injected test reducers receive it under the
        "p_elbounds" tag."""
        if self._allreduce is not None:
            return np.asarray(self._allreduce(np.asarray(bounds),
                                              "p_elbounds"))
        if self.n_hosts == 1:
            return np.asarray(bounds)
        import jax.numpy as jnp
        from jax.experimental import multihost_utils
        g = np.asarray(multihost_utils.process_allgather(
            jnp.asarray(bounds)))
        return np.array([g[:, 0].min(), g[:, 1].max()])


def simulated_comm(part, ctx, bc_idx, P_f, grids, n_hosts,
                   process_id=0, lame=False):
    """HostComm for a SIMULATED multi-host topology in one process: the
    other hosts' partials are assembled locally up front and summed
    through the same tag-keyed allreduce hook a real cross-host reduction
    uses.
    Shared by tests/test_multihost.py and __graft_entry__.dryrun_multichip
    so the reduction tags stay in one place next to build_cart_abf's."""
    from exsaddle_tpu.abf import stencil_from_csr
    from exsaddle_tpu.parallel.cart_abf import (assemble_host_local,
                                                local_element_partials)
    mesh = part.mesh
    nd = mesh.ndim
    lvl1 = tuple(reversed(grids[-2]))
    others = [assemble_host_local(part, ctx, bc_idx, P_f, grids,
                                  lame=lame,
                                  boxes=local_boxes(part, h, n_hosts))
              for h in range(n_hosts) if h != process_id]

    def allreduce(arr, tag):
        for o in others:
            if tag == "A1_stencil":
                arr = arr + stencil_from_csr(o["A1"], lvl1, nd)
            elif tag == "Mp_stencil":
                arr = arr + stencil_from_csr(
                    o["Mp"], tuple(reversed(mesh.nn_p)), 1)
            elif tag == "p_elbounds":
                arr = np.array([min(arr[0], o[tag][0]),
                                max(arr[1], o[tag][1])])
            else:
                arr = arr + o[tag]
        return arr

    # the other hosts' O(local) partial operators (fine esteig probe +
    # rhs_diri rows): a real runtime sums the result vectors across hosts
    apply_others = {"fine_esteig": [], "rhs_diri": []}
    for o in others:
        ua, rr = local_element_partials(mesh, o["el_ids_loc"],
                                        o["sv_loc"], bc_idx)
        apply_others["fine_esteig"].append(ua)
        apply_others["rhs_diri"].append(rr)

    return HostComm(n_hosts=n_hosts, process_id=process_id,
                    allreduce=allreduce, apply_others=apply_others)


def local_boxes(part, process_id, n_hosts):
    """The (ix, iy[, iz]) element boxes owned by `process_id`'s devices
    under a `host_partition` layout (host axis = outermost dim). Used to
    restrict per-shard setup to host-local assembly."""
    pz = part.dev_shape[-1]
    if pz % n_hosts:
        raise ValueError(f"outer device axis {pz} not divisible by "
                         f"{n_hosts} hosts")
    per_host = pz // n_hosts
    lo = process_id * per_host
    hi = lo + per_host
    return [b for b in part.dev_boxes() if lo <= b[-1] < hi]
