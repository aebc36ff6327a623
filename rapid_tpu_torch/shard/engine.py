"""Multi-device round loop: the protocol over a mesh of torch devices.

The port of ``rapid_tpu/shard/engine.py``. As there, the per-edge state (the
[C, K] planes that dominate memory and work) is row-sharded by *observer*
over every mesh axis, and the rest of the state is replicated. One round:

- local: each device runs the FD phase over the observer rows of every
  shard it holds, in one ``kernels.fd_phase_rows`` call (``device_groups``),
  and each shard's new DOWN alerts go as bits into its segment of a
  per-shard bitset (``kernels.segment_words``);
- exchange: the segments meet on the mesh's first ("home") device, C*K/8
  bytes (125 KB at 100k members). JAX's ``pmax`` over a destination-indexed
  int32 [C, K] delta moves 4 MB for the same bits;
- replicated: the home device gathers the alerts by destination
  (``kernels.fd_gather``), then runs delivery, cut detection and the vote
  tally (``engine.route_and_tally``) once, and sends the round counter and
  the halt flag back to every shard.

Where it departs from JAX, and why. The port is one process that drives
per-shard tensors (single controller, as JAX's ``shard_map`` is), but it
enqueues every op from the host, so the replicated part runs once, on home,
not on every shard: run on each it would multiply the host's enqueue, which
already bounds a decision. The replicated fields live once, on home; the
[C] node inputs the FD phase reads (``active``, ``alive``, ``drop_prob``)
are copied to every shard's device once per dispatch. The gather form of the
alert routing equals JAX's scatter form because ``observers[:, k]`` and
``subjects[:, k]`` are inverse permutations over the active slots; inactive
slots map to themselves and raise no alert, and a joiner's row of expected
observers is masked out by ``active`` in both forms.

A mesh is a grid of ``torch.device`` that may repeat: on one card every
shard is a separate set of tensors on ``cuda:0``, and one call a round
covers them all; in the tests every shard is on ``cpu``; on a machine with
several cards the shards spread over them, and the exchange is a peer copy
into home's bitset, one a device when its shards are consecutive in mesh
order. Shards on the home device write their segments in place.

Eager PyTorch cannot leave a loop on device data without a host sync, so the
"until" runner evaluates its whole budget, with the rounds after the
decision (and, under ``stop_when_announced``, after the first announcement)
as masked no-ops, as the single-device loops do; halted state stays
bit-equal. The FD kernel reads the halt flag on the device and leaves a
halted round's planes and key as they were, so neither is masked after it.

Random ingress loss draws from the replicated key as JAX's sharded round
does: each round splits it, and each shard draws its ``[C / n, K]`` block from
the probe half folded with its linear shard index (row-major over the mesh
axes). The device's ``fd_phase_rows`` call splits the key, folds each of its
shards' probe keys and makes each lossy edge's word where it reads it; home's
call gives the new key, with loss or without. The bits are JAX's, so
a lossy sharded run matches ``rapid_tpu.shard.engine`` round for round (it
differs from a single-device run in both packages, by the fold).

Several processes (``make_multihost_mesh(coordinator_address=...)``): every
process runs the same program over the same global mesh, as JAX's SPMD
processes do, and holds the rows of its own row of the mesh, a contiguous run
of shards (``Mesh.local_shards``); its first device is its home. Each round
every process runs its ``fd_phase_rows`` calls, then one all-gather over the
``torch.distributed`` group fills every home's bitset with every process's
segments (``C * K / 8`` bytes in all), and every process gathers, tallies and
decides on its own replicated state, which stays identical everywhere: the
counterpart of JAX's one ``pmax`` a round, with no second collective. Every
process evaluates every round of a budget, so all make the same collectives.
Shards keep their global index wherever a fold or a row offset needs one, so
a multi-process run equals the single-process run on a mesh of the same
shape bit for bit, random loss included. The group is gloo's: NCCL refuses
two ranks on one card, and gloo stages CUDA tensors through the host, so each
round waits once on the host (``jitwatch`` label ``shard.exchange``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import jitwatch
from ..sim import kernels
from ..sim.engine import (
    RoundInputs,
    SimConfig,
    SimState,
    _FIELDS,
    _select,
    fd_kernel_policy,
    route_and_tally,
)

NODES_AXIS = "nodes"
# how long a process waits for the others at start-up and in a collective
PROCESS_GROUP_TIMEOUT_S = 120.0

ROW, REP = "row", "rep"
# SimState fields row-sharded by observer; every other field is replicated
ROW_STATE_FIELDS = ("subjects", "fd_fail", "fd_hist", "fd_seen", "fd_streak", "fd_ok",
                    "alerted")
# the per-edge planes fd_phase_rows returns, in its order
_FD_OUTPUTS = ("fd_fail", "alerted", "fd_streak", "fd_ok", "fd_hist", "fd_seen")


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index (``cuda`` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of torch devices with named axes, the counterpart of
    ``jax.sharding.Mesh``: ``devices`` is a numpy object array of
    ``torch.device`` in the mesh's shape, and a device may appear more than
    once. Shard ``s`` (the row-major index over every axis) holds observer
    rows ``[s * C / n, (s + 1) * C / n)`` on ``device_list[s]``.

    Over several processes (``process_count > 1``, ``make_multihost_mesh``)
    the grid is global and process ``process_index`` holds the shards
    ``local_shards``, a contiguous run in mesh order; the exchange runs on
    the default ``torch.distributed`` group. ``collectives`` and
    ``collective_bytes`` count the collectives this process made on the mesh
    and the bytes each gathered."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_index: int = 0, process_count: int = 1) -> None:
        assert devices.ndim == len(axis_names), (
            f"{devices.ndim} axes need {devices.ndim} names, got {tuple(axis_names)}"
        )
        assert devices.size % process_count == 0 and 0 <= process_index < process_count
        self.devices = np.vectorize(_device, otypes=[object])(devices)
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count
        self.collectives = 0
        self.collective_bytes = 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> Tuple[torch.device, ...]:
        return tuple(self.devices.reshape(-1))

    @property
    def local_shards(self) -> range:
        """The shards this process holds: every shard in one process."""
        per = self.size // self.process_count
        return range(self.process_index * per, (self.process_index + 1) * per)

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """The devices of ``local_shards``, in mesh order."""
        return self.device_list[self.local_shards.start:self.local_shards.stop]

    @property
    def home(self) -> torch.device:
        """The device that holds this process's replicated state and runs
        the tally: its first shard's."""
        return self.device_list[self.local_shards.start]

    def __repr__(self) -> str:
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list]}{procs})"


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Optional[Tuple[str, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1D ``("nodes",)`` mesh by default; pass ``shape=(hosts, chips)``
    for a 2D ``("dcn", "ici")`` layout (names overridable). ``devices``: the
    devices to lay out, in order, repeats allowed (``[torch.device("cuda",
    0)] * 8`` puts eight shards on one card, ``["cpu"] * 8`` is the tests'
    mesh); by default every visible CUDA device. Without a GPU and without
    ``devices`` it raises: a mesh is never put on the CPU unasked."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[...] to build a mesh "
                "elsewhere (e.g. ['cpu'] * 8)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is not None:
        assert n_devices is None, "pass either n_devices or shape, not both"
        total = int(np.prod(shape))
        assert total <= len(devices), (
            f"mesh shape {shape} needs {total} devices, have {len(devices)}"
        )
        if axis_names is None:
            assert len(shape) <= 2, "pass axis_names for meshes beyond 2D"
            names = ("dcn", "ici")[-len(shape):]
        else:
            names = axis_names
        assert len(names) == len(shape), f"{len(shape)} axes need {len(shape)} names"
        grid = np.empty(total, dtype=object)
        grid[:] = devices[:total]
        return Mesh(grid.reshape(shape), names)
    if n_devices is not None:
        assert n_devices <= len(devices), (
            f"a mesh of {n_devices} devices needs {n_devices}, have {len(devices)}"
        )
        devices = devices[:n_devices]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (NODES_AXIS,))


def make_multihost_mesh(
    chips_per_host: Optional[int] = None,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    hosts: Optional[Sequence[Sequence]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """The ``("dcn", "ici")`` mesh whose rows are hosts (processes) and whose
    columns are each host's devices; ``chips_per_host`` truncates every row
    to a common width, and uneven rows raise ``ValueError`` naming each
    process's width.

    With ``coordinator_address`` (``host:port`` of process 0), one process a
    host: initializes ``torch.distributed`` with the gloo backend at
    ``tcp://<coordinator_address>``, ``world_size=num_processes`` and
    ``rank=process_id`` (``PROCESS_GROUP_TIMEOUT_S`` for start-up and every
    collective; a group already initialized is taken as it is), and this
    process's row
    is ``devices`` (repeats allowed: ``["cuda:0"] * 2``, ``["cpu"] * 2``), by
    default every visible CUDA device. The rows' widths and device names are
    exchanged, so uneven rows raise in every process. The mesh holds the
    global grid; this process's shards are its row (``Mesh.local_shards``).

    Without it, the degenerate single-process case: ``hosts`` lists each
    host's devices (one process has no process index to group devices by),
    by default one host with every visible CUDA device."""
    if coordinator_address is None:
        if hosts is None:
            hosts = [make_mesh().device_list]
        return _host_grid([list(h) for h in hosts], chips_per_host)
    import datetime

    import torch.distributed as dist

    if num_processes is None or process_id is None:
        raise ValueError("a coordinator_address needs num_processes and process_id")
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
        raise ValueError(
            f"torch.distributed is process {dist.get_rank()} of {dist.get_world_size()}, "
            f"not {process_id} of {num_processes}")
    mine = list(devices) if devices is not None else list(make_mesh().device_list)
    rows: List = [None] * num_processes
    dist.all_gather_object(rows, [str(_device(d)) for d in mine])
    rows[process_id] = mine  # this process's own devices, as given
    grid = _host_grid(rows, chips_per_host)
    return Mesh(grid.devices, grid.axis_names, process_index=process_id,
                process_count=num_processes)


def _host_grid(rows: List[List], chips_per_host: Optional[int]) -> Mesh:
    """The ("dcn", "ici") mesh of ``rows`` (each host's devices), each cut to
    ``chips_per_host``; uneven rows raise JAX's ``ValueError``."""
    out = []
    for proc, host_devices in enumerate(rows):
        per_host = chips_per_host if chips_per_host is not None else len(host_devices)
        assert per_host <= len(host_devices), (
            f"chips_per_host={per_host} exceeds process {proc}'s "
            f"{len(host_devices)} devices"
        )
        out.append(host_devices[:per_host])
    if len({len(r) for r in out}) != 1:
        raise ValueError(
            "uneven devices per process: "
            + ", ".join(f"process {p}: {len(r)}" for p, r in enumerate(out))
            + " -- a ('dcn', 'ici') mesh needs identical host rows; pass "
            "chips_per_host to truncate every host to a common width"
        )
    grid = np.empty((len(out), len(out[0])), dtype=object)
    for i, row in enumerate(out):
        grid[i, :] = row
    return Mesh(grid, ("dcn", "ici"))


def require_single_process(mesh: Optional[Mesh], what: str) -> None:
    """Raise for a mesh of several processes: ``what`` runs in one."""
    if mesh is not None and mesh.process_count > 1:
        raise ValueError(
            f"{what} runs in one process; a mesh of {mesh.process_count} processes "
            "(make_multihost_mesh with a coordinator_address) serves the Simulator only")


def state_shardings(mesh: Mesh) -> SimState:
    """Which ``SimState`` fields are row-sharded by observer over every mesh
    axis (``ROW``) and which are replicated (``REP``), as a ``SimState`` of
    those tags."""
    return SimState(**{f: ROW if f in ROW_STATE_FIELDS else REP for f in _FIELDS})


def input_shardings(mesh: Mesh) -> RoundInputs:
    """The same for ``RoundInputs``: ``probe_drop`` is row-sharded."""
    return RoundInputs(**{f.name: ROW if f.name == "probe_drop" else REP
                          for f in dataclasses.fields(RoundInputs)})


@dataclass(frozen=True)
class ShardedState(SimState):
    """A ``SimState`` placed on a mesh: the replicated fields on the home
    device and, in ``rows``, each shard's block of the row-sharded fields
    (``ROW_STATE_FIELDS``, ``[C / n, K]`` on that shard's device); the
    row-sharded fields of the ``SimState`` itself are None. Code that only
    reads or replaces replicated fields (the tally, the classic round, the
    driver's vote and group writes) takes it as it takes a ``SimState``.
    On a multi-process mesh ``rows`` holds this process's shards only
    (``Mesh.local_shards``, in order); ``mesh`` is the mesh it was placed
    on."""

    rows: Tuple[Dict[str, torch.Tensor], ...] = ()
    mesh: Optional["Mesh"] = None


@dataclass(frozen=True)
class ShardedInputs(RoundInputs):
    """``RoundInputs`` placed on a mesh: ``probe_drop`` is None and
    ``probe_drop_rows`` holds each shard's block; the rest is on home."""

    probe_drop_rows: Tuple[torch.Tensor, ...] = ()  # this process's shards


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself when it is there, else a copy queued on
    the stream (a peer copy between cards)."""
    return t.to(device, non_blocking=True)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return _device(a) == _device(b)


def _blocks(t: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Row blocks of ``t`` of this process's shards, each a fresh contiguous
    tensor on its shard's device (a slice would share storage and lose the
    kernel's alignment)."""
    rows = t.shape[0] // mesh.size
    return tuple(t[s * rows:(s + 1) * rows].to(mesh.device_list[s], non_blocking=True,
                                                 copy=True)
                 for s in mesh.local_shards)


def _check_capacity(capacity: int, mesh: Mesh) -> None:
    """Row sharding needs the capacity to divide over the mesh."""
    assert capacity % mesh.size == 0, (
        f"capacity {capacity} must divide evenly over {mesh.size} devices"
    )


def place_state(state: SimState, mesh: Mesh) -> ShardedState:
    """``state`` on ``mesh``: replicated fields on home, one block of ``C /
    n`` rows of each row-sharded field on each of this process's shards'
    devices (``state`` is the whole state, identical in every process)."""
    _check_capacity(state.active.shape[0], mesh)
    columns = {f: _blocks(getattr(state, f), mesh) for f in ROW_STATE_FIELDS}
    return ShardedState(
        **{f: None if f in ROW_STATE_FIELDS else _to(getattr(state, f), mesh.home)
           for f in _FIELDS},
        rows=tuple({f: columns[f][i] for f in ROW_STATE_FIELDS}
                   for i in range(len(mesh.local_shards))),
        mesh=mesh,
    )


def place_inputs(inputs: RoundInputs, mesh: Mesh) -> ShardedInputs:
    """``inputs`` on ``mesh``: ``probe_drop`` in row blocks of this process's
    shards, the rest on home."""
    _check_capacity(inputs.alive.shape[0], mesh)
    return ShardedInputs(
        **{f.name: None if f.name == "probe_drop" else _to(getattr(inputs, f.name), mesh.home)
           for f in dataclasses.fields(RoundInputs)},
        probe_drop_rows=_blocks(inputs.probe_drop, mesh),
    )


def _gather_ranks(mesh: Mesh, out: torch.Tensor, local: torch.Tensor, label: str) -> None:
    """``out`` (``process_count`` equal blocks, on home) takes every
    process's ``local`` in process order: one all-gather over the mesh's
    group, which every process must make. Gloo stages a CUDA tensor through
    the host and the host waits for it, so the wait is an audited sync."""
    import torch.distributed as dist

    with jitwatch.host_transfer(label):
        dist.all_gather(list(out.view(mesh.process_count, *local.shape).unbind(0)), local)
    mesh.collectives += 1
    mesh.collective_bytes += out.numel() * out.element_size()


def row_field(state: ShardedState, name: str) -> torch.Tensor:
    """The row-sharded field ``name`` of every shard, concatenated on home.
    On a multi-process mesh it is a collective (label ``shard.row_field``):
    every process must call it, for the same field, as JAX's processes must
    all join a fetch of a sharded array (a fetch of the shards another
    process holds fails there)."""
    home = state.active.device
    local = torch.cat([_to(block[name], home) for block in state.rows])
    mesh = state.mesh
    if mesh is None or mesh.process_count == 1:
        return local
    out = local.new_empty((mesh.process_count * local.shape[0],) + tuple(local.shape[1:]))
    _gather_ranks(mesh, out, local, "shard.row_field")
    return out


def gather_state(state: ShardedState) -> SimState:
    """The whole ``SimState`` on the home device: on a multi-process mesh a
    collective of every process, one ``row_field`` a row-sharded field."""
    return SimState(**{f: row_field(state, f) if f in ROW_STATE_FIELDS else getattr(state, f)
                       for f in _FIELDS})


def device_groups(mesh: Mesh) -> List[Tuple[torch.device, List[int]]]:
    """This process's shards (global indices) grouped by device, in the mesh
    order of each device's first shard, and within a device in mesh order,
    cut into runs of at most ``kernels.MAX_SHARDS_PER_CALL``: one
    ``fd_phase_rows`` call a group a round. On one card every mesh of up to
    16 shards is one group."""
    by_device: Dict[torch.device, List[int]] = {}
    for s in mesh.local_shards:
        by_device.setdefault(_device(mesh.device_list[s]), []).append(s)
    step = kernels.MAX_SHARDS_PER_CALL
    return [(d, shards[i:i + step]) for d, shards in by_device.items()
            for i in range(0, len(shards), step)]


def _copy_in(segment: torch.Tensor, source: torch.Tensor) -> None:
    """One copy of the exchange: segments into home's bitset (a peer copy
    between cards)."""
    segment.copy_(source, non_blocking=True)


def _exchange(bits: torch.Tensor, buffer: torch.Tensor, shards: Sequence[int],
              words: int) -> None:
    """Home's bitset ``bits`` takes the segments that a device off home wrote
    into ``buffer``, in the order of ``shards``: one copy when the shards are
    consecutive in mesh order, else one a shard."""
    first = shards[0]
    if list(shards) == list(range(first, first + len(shards))):
        _copy_in(bits[first * words:(first + len(shards)) * words], buffer)
    else:
        for i, s in enumerate(shards):
            _copy_in(bits[s * words:(s + 1) * words], buffer[i * words:(i + 1) * words])


@dataclass(frozen=True)
class _DeviceCall:
    """What one device's ``fd_phase_rows`` call reuses every round of a
    dispatch: its shards, the [C] node inputs and the node table on its
    device, and its segments, which are home's bitset itself on home and
    slices of ``buffer`` elsewhere."""

    device: torch.device
    shards: List[int]
    nodes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    node_table: torch.Tensor
    segments: List[torch.Tensor]
    buffer: Optional[torch.Tensor]


def _run(
    config: SimConfig, mesh: Mesh, state: ShardedState, inputs: ShardedInputs,
    rounds: int, random_loss: bool, stop_when_announced: bool,
) -> ShardedState:
    """``rounds`` sharded rounds, each masked once the state has decided
    (or, with ``stop_when_announced``, once a group has announced): the FD
    kernel reads the halt flag and leaves the planes and the key as they
    were, and the rest of the replicated state takes ``_select``. On a
    multi-process mesh each round makes one all-gather of this process's run
    of segments."""
    local = mesh.local_shards
    rows, k, g = config.capacity // mesh.size, config.k, config.groups
    words = kernels.segment_words(rows, k)
    policy = fd_kernel_policy(config)
    # once per dispatch: home's bitset, and for each device call its node
    # inputs, node table and segments
    bits = torch.empty(mesh.size * words, dtype=torch.int32, device=mesh.home)
    calls = []
    for dev, shards in device_groups(mesh):
        on_home = _same_device(dev, mesh.home)
        buffer = None if on_home else torch.empty(len(shards) * words, dtype=torch.int32,
                                                  device=dev)
        calls.append(_DeviceCall(
            dev, shards, (_to(state.active, dev), _to(inputs.alive, dev),
                          _to(inputs.drop_prob, dev) if random_loss else None),
            kernels.new_node_table(config.capacity, dev),
            [bits[s * words:(s + 1) * words] if on_home else buffer[i * words:(i + 1) * words]
             for i, s in enumerate(shards)],
            buffer,
        ))
    # this process's run of segments in home's bitset, which the all-gather
    # fills around it
    mine_bits = bits[local.start * words:local.stop * words]
    alive = inputs.alive & state.active
    obs = state.observers.long()
    blocks = list(state.rows)  # this process's shards, indexed s - local.start
    home = SimState(**{f: getattr(state, f) for f in _FIELDS})
    for _ in range(rounds):
        halt = home.decided
        if stop_when_announced:
            halt = halt | home.announced[:g].any()
        for call in calls:
            dev, mine = call.device, [blocks[s - local.start] for s in call.shards]

            def column(name):
                return [block[name] for block in mine]
            outs, key = kernels.fd_phase_rows(
                *call.nodes, column("subjects"),
                [inputs.probe_drop_rows[s - local.start] for s in call.shards],
                _to(home.rng_key, dev), column("fd_fail"), column("alerted"),
                column("fd_streak"), column("fd_ok"), _to(home.round, dev), call.segments,
                row0=[s * rows for s in call.shards], fold=call.shards,
                fd_hist=column("fd_hist"), fd_seen=column("fd_seen"), halt=_to(halt, dev),
                node_table=call.node_table, **policy,
            )
            if call is calls[0]:
                # home's call (device_groups starts at the process's first
                # shard): its split is the replicated key
                rng_key = key
            if call.buffer is not None:
                _exchange(bits, call.buffer, call.shards, words)
            for s, block, out in zip(call.shards, mine, outs):
                blocks[s - local.start] = {**block, **dict(zip(_FD_OUTPUTS, out))}
        if mesh.process_count > 1:
            _gather_ranks(mesh, bits, mine_bits, "shard.exchange")
        down_arrivals = kernels.fd_gather(home.active, home.observers, inputs.down_reports,
                                          bits, rows)
        tallied = route_and_tally(config, home, down_arrivals, inputs, home.active, alive,
                                  observers_idx=obs)
        # the FD kernel has already kept a halted round's key
        home = _select(halt, dataclasses.replace(home, rng_key=rng_key), dataclasses.replace(
            tallied, alive=inputs.alive, round=home.round + 1, rng_key=rng_key))
    return ShardedState(**{f: getattr(home, f) for f in _FIELDS}, rows=tuple(blocks),
                        mesh=mesh)


Runner = Callable[..., ShardedState]


def make_sharded_run(
    config: SimConfig, mesh: Mesh, rounds: int, random_loss: bool = True
) -> Runner:
    """The multi-device round loop of ``rounds`` rounds, masked after the
    decision: ``run(state, inputs)`` on a placed state and placed inputs
    (``place_state``, ``place_inputs``). With ``random_loss`` each shard
    draws from the state's key every round. The input state is not
    modified."""
    _check_capacity(config.capacity, mesh)

    def run(state: ShardedState, inputs: ShardedInputs) -> ShardedState:
        return _run(config, mesh, state, inputs, rounds, random_loss, False)

    return run


def make_sharded_run_until(
    config: SimConfig, mesh: Mesh, random_loss: bool = True,
    stop_when_announced: bool = False,
) -> Runner:
    """One dispatch of a decision: ``run_until(state, inputs, max_rounds)``
    evaluates ``max_rounds`` rounds, those after the decision (and, with
    ``stop_when_announced``, after the first group announcement) as masked
    no-ops that keep the key, so it ends where JAX's ``while_loop`` stops,
    with the same state. The budget is a plain argument: every batch size
    shares one runner. The same round body as ``make_sharded_run``, so the
    two give equal states after equal budgets."""
    _check_capacity(config.capacity, mesh)

    def run_until(state: ShardedState, inputs: ShardedInputs, max_rounds: int) -> ShardedState:
        return _run(config, mesh, state, inputs, max_rounds, random_loss,
                    stop_when_announced)

    return run_until
