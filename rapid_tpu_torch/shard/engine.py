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
halted round's planes as they were, so no plane is masked after it.

Random ingress loss: each shard draws its ``[C / n, K]`` block from its own
``torch.Generator`` on its device (``shard_generators``). JAX folds the shard
index into its key, so a lossy sharded run differs from a single-device run
in both packages; such runs compare by outcome.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
_ROADMAP = "see ROADMAP.md, Queue 1 item 7"

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
    rows ``[s * C / n, (s + 1) * C / n)`` on ``device_list[s]``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        assert devices.ndim == len(axis_names), (
            f"{devices.ndim} axes need {devices.ndim} names, got {tuple(axis_names)}"
        )
        self.devices = np.vectorize(_device, otypes=[object])(devices)
        self.axis_names = tuple(axis_names)

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
    def home(self) -> torch.device:
        """The device that holds the replicated state and runs the tally."""
        return self.device_list[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list]})"


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
) -> Mesh:
    """The ``("dcn", "ici")`` mesh whose rows are hosts and whose columns are
    each host's devices, in the degenerate single-process case: ``hosts``
    lists each host's devices (one process has no process index to group
    devices by), by default one host with every visible CUDA device.
    ``chips_per_host`` truncates every host to a common width; uneven host
    rows are rejected. A ``coordinator_address`` (one process per host, over
    ``torch.distributed``) is not ported yet and raises."""
    if coordinator_address is not None:
        raise NotImplementedError(
            f"multi-process meshes over torch.distributed are not ported yet ({_ROADMAP})"
        )
    if hosts is None:
        hosts = [make_mesh().device_list]
    rows = []
    for proc, host_devices in enumerate(hosts):
        host_devices = list(host_devices)
        per_host = chips_per_host if chips_per_host is not None else len(host_devices)
        assert per_host <= len(host_devices), (
            f"chips_per_host={per_host} exceeds process {proc}'s "
            f"{len(host_devices)} devices"
        )
        rows.append(host_devices[:per_host])
    if len({len(r) for r in rows}) != 1:
        raise ValueError(
            "uneven devices per process: "
            + ", ".join(f"process {p}: {len(r)}" for p, r in enumerate(rows))
            + " -- a ('dcn', 'ici') mesh needs identical host rows; pass "
            "chips_per_host to truncate every host to a common width"
        )
    grid = np.empty((len(rows), len(rows[0])), dtype=object)
    for i, row in enumerate(rows):
        grid[i, :] = row
    return Mesh(grid, ("dcn", "ici"))


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
    driver's vote and group writes) takes it as it takes a ``SimState``."""

    rows: Tuple[Dict[str, torch.Tensor], ...] = ()


@dataclass(frozen=True)
class ShardedInputs(RoundInputs):
    """``RoundInputs`` placed on a mesh: ``probe_drop`` is None and
    ``probe_drop_rows`` holds each shard's block; the rest is on home."""

    probe_drop_rows: Tuple[torch.Tensor, ...] = ()


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself when it is there, else a copy queued on
    the stream (a peer copy between cards)."""
    return t.to(device, non_blocking=True)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return _device(a) == _device(b)


def _blocks(t: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Row blocks of ``t``, each a fresh contiguous tensor on its shard's
    device (a slice would share storage and lose the kernel's alignment)."""
    rows = t.shape[0] // mesh.size
    return tuple(t[s * rows:(s + 1) * rows].to(d, non_blocking=True, copy=True)
                 for s, d in enumerate(mesh.device_list))


def _check_capacity(capacity: int, mesh: Mesh) -> None:
    """Row sharding needs the capacity to divide over the mesh."""
    assert capacity % mesh.size == 0, (
        f"capacity {capacity} must divide evenly over {mesh.size} devices"
    )


def place_state(state: SimState, mesh: Mesh) -> ShardedState:
    """``state`` on ``mesh``: replicated fields on home, one block of ``C /
    n`` rows of each row-sharded field on each shard's device."""
    _check_capacity(state.active.shape[0], mesh)
    columns = {f: _blocks(getattr(state, f), mesh) for f in ROW_STATE_FIELDS}
    return ShardedState(
        **{f: None if f in ROW_STATE_FIELDS else _to(getattr(state, f), mesh.home)
           for f in _FIELDS},
        rows=tuple({f: columns[f][s] for f in ROW_STATE_FIELDS} for s in range(mesh.size)),
    )


def place_inputs(inputs: RoundInputs, mesh: Mesh) -> ShardedInputs:
    """``inputs`` on ``mesh``: ``probe_drop`` in row blocks, the rest on home."""
    _check_capacity(inputs.alive.shape[0], mesh)
    return ShardedInputs(
        **{f.name: None if f.name == "probe_drop" else _to(getattr(inputs, f.name), mesh.home)
           for f in dataclasses.fields(RoundInputs)},
        probe_drop_rows=_blocks(inputs.probe_drop, mesh),
    )


def row_field(state: ShardedState, name: str) -> torch.Tensor:
    """The row-sharded field ``name`` of every shard, concatenated on home."""
    home = state.active.device
    return torch.cat([_to(block[name], home) for block in state.rows])


def gather_state(state: ShardedState) -> SimState:
    """The whole ``SimState`` on the home device."""
    return SimState(**{f: row_field(state, f) if f in ROW_STATE_FIELDS else getattr(state, f)
                       for f in _FIELDS})


def shard_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s random-loss generator in a
    configuration seeded ``seed``: ``(seed << 16 | shard) mod 2**64``, for
    shard indices below 2**16."""
    assert 0 <= shard < 1 << 16
    return ((seed << 16) | shard) % (1 << 64)


def shard_generators(mesh: Mesh, seed: int) -> List[torch.Generator]:
    """One ``torch.Generator`` a shard, on its device, seeded by
    ``shard_seed``."""
    return [torch.Generator(device=d).manual_seed(shard_seed(seed, s))
            for s, d in enumerate(mesh.device_list)]


def device_groups(mesh: Mesh) -> List[Tuple[torch.device, List[int]]]:
    """The mesh's shards grouped by device, in the mesh order of each
    device's first shard, and within a device in mesh order, cut into runs of
    at most ``kernels.MAX_SHARDS_PER_CALL``: one ``fd_phase_rows`` call a
    group a round. On one card every mesh of up to 16 shards is one group."""
    by_device: Dict[torch.device, List[int]] = {}
    for s, d in enumerate(mesh.device_list):
        by_device.setdefault(_device(d), []).append(s)
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
    rounds: int, random_loss: bool, generators: Optional[Sequence[torch.Generator]],
    stop_when_announced: bool,
) -> ShardedState:
    """``rounds`` sharded rounds, each masked once the state has decided
    (or, with ``stop_when_announced``, once a group has announced): the FD
    kernel reads the halt flag and leaves the planes as they were, and the
    replicated state takes ``_select``."""
    if random_loss and (generators is None or len(generators) != mesh.size):
        raise ValueError("random_loss needs one torch.Generator a shard")
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
                          _to(inputs.drop_prob, dev)),
            kernels.new_node_table(config.capacity, dev),
            [bits[s * words:(s + 1) * words] if on_home else buffer[i * words:(i + 1) * words]
             for i, s in enumerate(shards)],
            buffer,
        ))
    alive = inputs.alive & state.active
    obs = state.observers.long()
    blocks = list(state.rows)
    home = SimState(**{f: getattr(state, f) for f in _FIELDS})
    for _ in range(rounds):
        halt = home.decided
        if stop_when_announced:
            halt = halt | home.announced[:g].any()
        for call in calls:
            dev, mine = call.device, [blocks[s] for s in call.shards]

            def column(name):
                return [block[name] for block in mine]
            draws = ([torch.rand((rows, k), generator=generators[s], device=dev)
                      for s in call.shards] if random_loss else None)
            outs = kernels.fd_phase_rows(
                *call.nodes, column("subjects"), [inputs.probe_drop_rows[s] for s in call.shards],
                draws, column("fd_fail"), column("alerted"), column("fd_streak"),
                column("fd_ok"), _to(home.round, dev), call.segments,
                row0=[s * rows for s in call.shards], fd_hist=column("fd_hist"),
                fd_seen=column("fd_seen"), halt=_to(halt, dev), node_table=call.node_table,
                **policy,
            )
            if call.buffer is not None:
                _exchange(bits, call.buffer, call.shards, words)
            for s, block, out in zip(call.shards, mine, outs):
                blocks[s] = {**block, **dict(zip(_FD_OUTPUTS, out))}
        down_arrivals = kernels.fd_gather(home.active, home.observers, inputs.down_reports,
                                          bits, rows)
        tallied = route_and_tally(config, home, down_arrivals, inputs, home.active, alive,
                                  observers_idx=obs)
        home = _select(halt, home, dataclasses.replace(
            tallied, alive=inputs.alive, round=home.round + 1))
    return ShardedState(**{f: getattr(home, f) for f in _FIELDS}, rows=tuple(blocks))


Runner = Callable[..., ShardedState]


def make_sharded_run(
    config: SimConfig, mesh: Mesh, rounds: int, random_loss: bool = True
) -> Runner:
    """The multi-device round loop of ``rounds`` rounds, masked after the
    decision: ``run(state, inputs, generators=None)`` on a placed state and
    placed inputs (``place_state``, ``place_inputs``). With ``random_loss``
    each shard draws from its generator in ``generators`` (one a shard,
    ``shard_generators``) every round. The input state is not modified."""
    _check_capacity(config.capacity, mesh)

    def run(state: ShardedState, inputs: ShardedInputs,
            generators: Optional[Sequence[torch.Generator]] = None) -> ShardedState:
        return _run(config, mesh, state, inputs, rounds, random_loss, generators, False)

    return run


def make_sharded_run_until(
    config: SimConfig, mesh: Mesh, random_loss: bool = True,
    stop_when_announced: bool = False,
) -> Runner:
    """One dispatch of a decision: ``run_until(state, inputs, max_rounds,
    generators=None)`` evaluates ``max_rounds`` rounds, those after the
    decision (and, with ``stop_when_announced``, after the first group
    announcement) as masked no-ops, so it ends where JAX's ``while_loop``
    stops, with the same state. The budget is a plain argument: every batch
    size shares one runner. The same round body as ``make_sharded_run``, so
    the two give equal states and generators after equal budgets."""
    _check_capacity(config.capacity, mesh)

    def run_until(state: ShardedState, inputs: ShardedInputs, max_rounds: int,
                  generators: Optional[Sequence[torch.Generator]] = None) -> ShardedState:
        return _run(config, mesh, state, inputs, max_rounds, random_loss, generators,
                    stop_when_announced)

    return run_until
