"""AcceleratedUnit — units whose run() is one step over device tensors
(the port of ``veles_tpu/accelerated_units.py``).

- An accelerated unit declares the attributes it READS and WRITES and
  implements one :meth:`AcceleratedUnit.step` over torch tensors.
- ``Array`` objects are the registers between units: ``link_attrs``
  aliases an attribute to the upstream unit's Array, so a segment's plan
  can key the dataflow by Array identity.
- :class:`AcceleratedWorkflow` groups consecutive accelerated units into
  a :class:`FusedSegment` with the reference's plan (donated / held /
  output slots, ref: veles_tpu/accelerated_units.py:191).  The reference
  compiles a segment into one jitted XLA program; the port runs the
  planned units' steps eagerly in that order, each launching its own
  kernels, so a segment gives the values that one program gives.
- The reference's ``enable_persistent_compile_cache`` (``:39``) turns
  on XLA's on-disk compile cache; nothing compiles on the port's eager
  path, so it has no counterpart here (the CUDA kernels are built once
  per checkout by :mod:`veles_tpu_torch._build`).
"""

from veles_tpu_torch.backends import compute_power, resolve_device
from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Workflow


class AcceleratedUnit(Unit):
    """A unit whose run() is one step over its declared attributes
    (ref: veles/accelerated_units.py:130).

    Subclasses declare::

        READS  = ("input", "weights", "bias")   # consumed attrs (Arrays)
        WRITES = ("output", "weights", "bias")  # produced attrs

    and implement :meth:`step`.  An attr in both READS and WRITES is
    *state* (the reference donates its buffer to the compiled program).
    """

    hide_from_registry = True

    READS = ()
    WRITES = ()
    #: units that override run() or mutate host state per-iteration set
    #: this False so fuse() leaves them standalone
    FUSABLE = True

    def __init__(self, workflow, **kwargs):
        super(AcceleratedUnit, self).__init__(workflow, **kwargs)
        self.device = None

    def init_unpickled(self):
        super(AcceleratedUnit, self).init_unpickled()
        self._segment_ = None

    @property
    def reads(self):
        return self.READS

    @property
    def writes(self):
        return self.WRITES

    # -- subclass contract ---------------------------------------------------

    def step(self, **tensors):
        """``{read attr: tensor} -> {write attr: tensor}``, with no side
        effects (a segment calls it with its own values)."""
        raise NotImplementedError(
            "%s must implement step()" % type(self).__name__)

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, device=None, **kwargs):
        super(AcceleratedUnit, self).initialize(**kwargs)
        if device is not None:
            self.device = resolve_device(device)
        for attr in set(self.reads) | set(self.writes):
            arr = getattr(self, attr, None)
            if isinstance(arr, Array):
                arr.initialize(self.device)

    def run(self):
        if self._segment_ is not None:
            self._segment_.run_for(self)
        else:
            self._run_standalone()

    # -- standalone execution ------------------------------------------------

    def _gather(self):
        tensors = {}
        for attr in self.reads:
            val = getattr(self, attr)
            tensors[attr] = val.devmem if isinstance(val, Array) else val
        return tensors

    def _scatter(self, outputs):
        for attr, val in outputs.items():
            target = getattr(self, attr, None)
            if isinstance(target, Array):
                target.devmem = val
            else:
                setattr(self, attr, val)

    def _run_standalone(self):
        self._scatter(self.step(**self._gather()))


class FusedSegment:
    """A maximal region of accelerated units run as one segment: the
    reference compiles it into one jitted XLA program, the port runs the
    planned steps eagerly in the plan's order.

    The scheduler still walks every unit's gates; the first member to run
    in an iteration executes the whole segment, and the remaining
    members' run() calls are satisfied from it.
    """

    def __init__(self, units):
        self.units = list(units)
        self._pending = set()
        self._fallback = False
        # stable Array registry: id -> (index, array)
        self._arrays = []
        self._plan = None

    # -- planning ------------------------------------------------------------

    def _array_key(self, arr, registry):
        key = registry.get(id(arr))
        if key is None:
            key = len(self._arrays)
            registry[id(arr)] = key
            self._arrays.append(arr)
        return key

    def plan(self):
        """Resolve each unit's attrs to Array slots; classify slots into
        donated (read+written) / held (read-only) inputs and outputs."""
        registry = {}
        unit_io = []
        written = set()
        read_before_write = set()
        all_written = set()
        for u in self.units:
            ins, outs = {}, {}
            for attr in u.reads:
                arr = getattr(u, attr)
                if not isinstance(arr, Array):
                    raise TypeError("%s.%s is not an Array" % (u, attr))
                k = self._array_key(arr, registry)
                ins[attr] = k
                if k not in written:
                    read_before_write.add(k)
            for attr in u.writes:
                arr = getattr(u, attr)
                if not isinstance(arr, Array):
                    raise TypeError("%s.%s is not an Array" % (u, attr))
                k = self._array_key(arr, registry)
                outs[attr] = k
                written.add(k)
                all_written.add(k)
            unit_io.append((u, ins, outs))
        donated = sorted(read_before_write & all_written)
        held = sorted(read_before_write - all_written)
        outputs = sorted(all_written)
        self._plan = (unit_io, donated, held, outputs)
        return self._plan

    def _fused(self, donated_vals, held_vals):
        unit_io, donated, held, outputs = self._plan
        env = dict(zip(donated, donated_vals))
        env.update(zip(held, held_vals))
        for u, ins, outs in unit_io:
            tensors = {a: env[k] for a, k in ins.items()}
            result = u.step(**tensors)
            for a, k in outs.items():
                env[k] = result[a]
        return tuple(env[k] for k in outputs)

    # -- execution -----------------------------------------------------------

    def _execute(self):
        if self._plan is None:
            self.plan()
        _, donated, held, outputs = self._plan
        results = self._fused(
            tuple(self._arrays[k].devmem for k in donated),
            tuple(self._arrays[k].devmem for k in held))
        for k, v in zip(outputs, results):
            self._arrays[k].devmem = v

    def run_for(self, unit):
        """Called from each member's run().  The scheduler already
        enforces gates, so a member whose gate_skip/gate_block is set
        never arrives here — an iteration where any member's gate is
        engaged must therefore run per-unit, not fused."""
        if unit not in self._pending:
            # new iteration: either the previous one drained, or it never
            # did because a gate_block cut propagation mid-chain
            expected = {u for u in self.units
                        if not u.gate_skip and not u.gate_block}
            self._fallback = expected != set(self.units)
            if not self._fallback:
                self._execute()
            self._pending = expected
        self._pending.discard(unit)
        if self._fallback:
            unit._run_standalone()

    def __repr__(self):
        return "<FusedSegment %s>" % [u.name for u in self.units]


class AcceleratedWorkflow(Workflow):
    """Workflow owning a device; fuses accelerated-unit chains at
    initialize time (ref: veles/accelerated_units.py:827).
    ``initialize(device=None)`` runs on the card; ``device="cpu"`` only
    when asked."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        super(AcceleratedWorkflow, self).__init__(workflow, **kwargs)
        self.device = None

    def init_unpickled(self):
        super(AcceleratedWorkflow, self).init_unpickled()
        self._segments_ = []

    def initialize(self, device=None, **kwargs):
        device = resolve_device(device)
        self.device = device
        super(AcceleratedWorkflow, self).initialize(device=device, **kwargs)
        # always clear stale segment bindings from a previous initialize
        # (graph may have been rewired, or fusion turned off)
        self._segments_ = []
        for u in self.units:
            if isinstance(u, AcceleratedUnit):
                u._segment_ = None
        self.fuse()

    def fuse(self):
        """Find maximal SINGLE-ENTRY convex regions of accelerated units
        and make each a :class:`FusedSegment`.

        A segment grows from an entry unit by repeatedly absorbing any
        fusable unit ALL of whose predecessors are already members —
        this admits fan-out and fan-in (InputJoiner diamonds) inside
        the segment, not just linear chains, while keeping execution
        correct: only the entry has edges from outside, so when the
        scheduler releases the entry every member's inputs exist, and
        the grow order is a topological order of the region (each
        member was added after all its predecessors)."""
        self._segments_ = []

        def fusable(u):
            return isinstance(u, AcceleratedUnit) and u.FUSABLE

        accel = [u for u in self.units if fusable(u)]
        accel_set = set(accel)
        # visit candidate entries in TOPOLOGICAL order of the fusable
        # subgraph — unit insertion order is not reliable (a unit
        # linked before its predecessor was created would otherwise
        # become an entry and strand that predecessor unfused).  Kahn;
        # cycle remainders (only possible via gated loops) keep
        # insertion order.
        indeg = {u: sum(1 for p in u.links_from if p in accel_set)
                 for u in accel}
        ready = [u for u in accel if indeg[u] == 0]
        topo = []
        while ready:
            u = ready.pop(0)
            topo.append(u)
            for v in u.links_to:
                if v in indeg:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        ready.append(v)
        done = set(topo)
        topo += [u for u in accel if u not in done]
        in_segment = set()

        for entry in topo:
            if entry in in_segment:
                continue
            members = [entry]
            member_set = {entry}
            grown = True
            while grown:
                grown = False
                # scan the frontier: successors of members whose every
                # predecessor is already inside
                for m in list(members):
                    for v in m.links_to:
                        if (v in accel_set and v not in member_set
                                and v not in in_segment
                                and v.links_from
                                and all(p in member_set
                                        for p in v.links_from)):
                            members.append(v)
                            member_set.add(v)
                            grown = True
            if len(members) > 1:
                in_segment |= member_set
                seg = FusedSegment(members)
                for member in members:
                    member._segment_ = seg
                self._segments_.append(seg)
        if self._segments_:
            self.debug("fused %d segment(s): %s", len(self._segments_),
                       self._segments_)
        return self._segments_

    @property
    def computing_power(self):
        """Device rating for the elastic coordinator handshake
        (ref: veles/accelerated_units.py:843-858)."""
        return compute_power(self.device) if self.device else 0.0


class DeviceBenchmark(AcceleratedUnit):
    """Unit exposing the GEMM probe (:func:`backends.compute_power`)
    in-graph (ref: veles/accelerated_units.py:706)."""

    FUSABLE = False  # no step(); runs host-side at initialize

    def __init__(self, workflow, **kwargs):
        super(DeviceBenchmark, self).__init__(workflow, **kwargs)
        self.computing_power = 0.0

    def initialize(self, device=None, **kwargs):
        super(DeviceBenchmark, self).initialize(device=device, **kwargs)
        if self.device is not None:
            self.computing_power = compute_power(self.device)

    def run(self):
        pass
