"""Vectorized placement: the device-plane mirror of placement/engine.py.

The port of ``rapid_tpu/placement/device.py``. The same arithmetic as the
object model over a ``[P, C]`` score matrix (P partitions x C candidate
slots), whose top-R runs on the device:

- ``placement_topr``: the rendezvous top-R of a set of partition rows
  against a set of candidate columns, in the hand-written CUDA kernel
  ``csrc/placement_topr.cu`` on a CUDA tensor and in its plain PyTorch
  version ``placement_topr_plain`` on a CPU one. Nothing of ``[P, C]`` is
  materialised by the kernel; the plain version works in row chunks.
  ``topr_plan`` sizes the kernel's launch (rows a lane, column slices a
  cluster, the tile of columns a stage, shared memory) to the card.
- ``topr_full``: the full ``[P, R]`` build through it (the JAX package's
  chunked numpy path, whose results it gives bit for bit).
- ``DevicePlacement.apply_view_change``: the incremental path driven from
  the simulator's view changes. Removals recompute only the rows whose
  replica set meets the removed slots; additions merge only the new columns
  into the stored top-R -- together exactly the minimal-motion set. Both
  run as ``placement_topr`` calls, and the map comes back to the host (where
  handoff and serving read it) in one audited fetch.
- ``build_jit``: the whole map in one call, its rows split over the
  devices of a ``shard.engine.Mesh`` when one is given.

Ranking is by ``(score desc, slot index asc)``, encoded branch-free as the
uint64 composite ``(score << 32) | (0xFFFFFFFF - slot)``, 0 for a column
that is not a candidate; composites are unique per column, so the order is
total and every path gives the same map.

Every entry point takes ``device`` last: CUDA unless the caller names
another (``"cpu"`` for the tests); without a GPU and without an explicit
device it raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..hashing import endpoint_hash_batch, to_signed, xxh64, xxh64_batch_auto
from ..observability import profiler_range
from ..runtime import jitwatch
from ..sim import kernels
from ..sim.engine import resolve_device
from .engine import GOLDEN64, MIX1, MIX2, PlacementConfig

_U32 = np.uint32
_U64 = np.uint64
_REV = _U64(0xFFFFFFFF)

# the largest replica count placement_topr takes (csrc/placement_topr.cu, kMaxR)
MAX_REPLICAS = 16
# the launch plan's limits, as csrc/placement_topr.cu has them: warps (and
# threads, a row each) a block, ring stages, slices a cluster (above 8
# non-portable), a block's shared memory, the tile of columns
TOPR_WARPS = 8
TOPR_THREADS = 32 * TOPR_WARPS
TOPR_STAGES = 3
TOPR_MAX_SLICES = 16
TOPR_MAX_SMEM = 232_448
TOPR_MIN_TILE = 32
TOPR_MAX_TILE = 512
# the card's SMs (an H100 SXM), and the grids topr_plan aims at: four blocks
# an SM, one for the merge (topr_variants.py's timings on an H100, PERF.md)
TOPR_SMS = 132
TOPR_GRID = 512
TOPR_GRID_MERGE = 128
# a stage ring of at most this many bytes leaves room for two blocks an SM
_TOPR_RING_BUDGET = 96 * 1024

__all__ = [
    "DeviceDiff",
    "DevicePlacement",
    "MAX_REPLICAS",
    "ToprPlan",
    "build_jit",
    "instance_keys32",
    "node_keys64",
    "partition_keys32",
    "placement_topr",
    "placement_topr_plain",
    "split_topr",
    "topr_full",
    "topr_plan",
]


def _fold32(h: np.ndarray) -> np.ndarray:
    """uint64[N] -> uint32[N]; mirrors engine.fold32."""
    return ((h ^ (h >> _U64(32))) & _REV).astype(_U32)


def partition_keys32(partitions: int, seed: int) -> np.ndarray:
    """engine.partition_key32 for all P at once: batched xxh64 over the
    8-LE-byte rows of the partition indices."""
    idx = np.arange(partitions, dtype=np.int64)
    data = (
        (idx[:, None] >> (8 * np.arange(8, dtype=np.int64))[None, :]) & 0xFF
    ).astype(np.uint8)
    lengths = np.full(partitions, 8, dtype=np.int64)
    return _fold32(xxh64_batch_auto(data, lengths, seed))


def node_keys64(
    hostnames: np.ndarray, host_lengths: np.ndarray, ports: np.ndarray, seed: int
) -> np.ndarray:
    """engine.node_key64 for all C slots at once; uint64[C]."""
    return endpoint_hash_batch(hostnames, host_lengths, ports, seed)


def instance_keys32(keys64: np.ndarray, max_weight: int) -> np.ndarray:
    """[V, C] uint32 virtual-instance keys; row v is every node's key
    advanced by v golden steps (engine.instance_key32)."""
    v = np.arange(max_weight, dtype=_U64)[:, None] * _U64(GOLDEN64)
    with np.errstate(over="ignore"):
        return _fold32(keys64[None, :].astype(_U64) + v)


# --------------------------------------------------------------------- #
# The top-R: plain version, kernel wrapper, host split
# --------------------------------------------------------------------- #

_M32 = 0xFFFFFFFF
# rows per chunk of the plain version, sized so the [B, M] int64 keys stay
# ~64 MB (the JAX package's topr_full chunks alike)
_CHUNK_ELEMS = 8_000_000


def _mul32(h: torch.Tensor, k: int) -> torch.Tensor:
    """(h * k) mod 2^32 for int64 lanes holding uint32 values, in two 16-bit
    halves of k so no product leaves int64's range."""
    lo = h * (k & 0xFFFF)
    hi = ((h * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """engine.mix32 over int64 lanes holding uint32 values (broadcasting)."""
    h = _mul32(a ^ b, MIX1)
    h = h ^ (h >> 15)
    h = _mul32(h, MIX2)
    return h ^ (h >> 13)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 lanes holding uint32 bits -> int64 lanes holding the value."""
    return t.to(torch.int64) & _M32


def _bits32(t: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding uint32 values -> int32 lanes holding their bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def _sort_keys(scores: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The uint64 composite ``(score << 32) | (0xFFFFFFFF - col)`` with its
    top bit flipped, as int64: the same order, held in signed lanes."""
    return (scores - (1 << 31)) * (1 << 32) + (_M32 - cols)


_NO_CANDIDATE = -(1 << 63)  # the composite 0, top bit flipped


def placement_topr_plain(
    part32: torch.Tensor, inst32: torch.Tensor, weights: torch.Tensor,
    active: Optional[torch.Tensor], replicas: int, cols: Optional[torch.Tensor] = None,
    prior: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The rendezvous top-R in plain PyTorch ops, chunked over rows. Takes
    what ``placement_topr`` takes and returns the same ``[B, 2R]`` int32
    map: each row's ``replicas`` best candidates, descending, as assign
    (``-1`` for an empty place) then score bits. The mix runs in int64
    lanes masked to 32 bits; the top-R is a ``torch.topk`` over the
    composite with its top bit flipped, so the uint64 order holds."""
    dev = part32.device
    n_rows = part32.shape[0]
    n_inst = inst32.shape[0]
    col_idx = (cols.to(torch.int64) if cols is not None
               else torch.arange(inst32.shape[1], dtype=torch.int64, device=dev))
    inst = _u32(inst32)[:, col_idx]  # [V, M]
    w = weights.to(torch.int64)[col_idx]
    valid = (active[col_idx] if cols is None
             else torch.ones(col_idx.shape[0], dtype=torch.bool, device=dev))
    m = col_idx.shape[0]
    out = torch.empty((n_rows, 2 * replicas), dtype=torch.int32, device=dev)
    block = max(1, _CHUNK_ELEMS // max(m, 1))
    for start in range(0, n_rows, block):
        sub = _u32(part32[start:start + block])[:, None]
        acc = torch.zeros((sub.shape[0], m), dtype=torch.int64, device=dev)
        for v in range(n_inst):
            s = _mix32(sub, inst[v][None, :])
            acc = torch.maximum(acc, torch.where((w > v)[None, :], s, 0))
        keys = torch.where(valid[None, :], _sort_keys(acc, col_idx[None, :]), _NO_CANDIDATE)
        if prior is not None:
            pa = prior[start:start + block, :replicas].to(torch.int64)
            ps = _u32(prior[start:start + block, replicas:])
            keys = torch.cat(
                [keys, torch.where(pa >= 0, _sort_keys(ps, pa), _NO_CANDIDATE)], dim=1)
        k = min(replicas, keys.shape[1])
        top = keys.topk(k, dim=1).values if k else keys[:, :0]
        if k < replicas:
            pad = torch.full((top.shape[0], replicas - k), _NO_CANDIDATE,
                             dtype=torch.int64, device=dev)
            top = torch.cat([top, pad], dim=1)
        empty = top == _NO_CANDIDATE
        assign = torch.where(empty, -1, _M32 - (top & _M32))
        score = (top >> 32) + (1 << 31)
        out[start:start + block, :replicas] = assign.to(torch.int32)
        out[start:start + block, replicas:] = _bits32(score)
    return out


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _topr_stage_bytes(tile_cols: int, n_inst: int) -> int:
    """One ring stage: keys [V, T] u32, effective weights and columns [T]
    i32, a flag a group of 16 columns, the mask's covering words [T + 8] u8
    (kernel: ``stage_bytes``)."""
    t = tile_cols
    return _round16(4 * t * n_inst + 8 * t + 4 * (t // 16) + t + 8)


def _topr_smem(tile_cols: int, n_inst: int, replicas: int) -> int:
    """The kernel's shared memory: the ring and, with several instance rows,
    the weight sort's scratch stage (keys, weights, columns, two histograms),
    or the block's lists laid over them after the last tile; then a floor a
    row (kernel: ``smem_need``)."""
    t = tile_cols
    sort = _round16(4 * t * n_inst + 8 * t + 8 * (n_inst + 2)) if n_inst > 1 else 0
    work = TOPR_STAGES * _topr_stage_bytes(t, n_inst) + sort
    return _round16(max(work, 8 * replicas * TOPR_THREADS)) + 4 * TOPR_THREADS


@dataclass(frozen=True)
class ToprPlan:
    """A ``placement_topr`` launch. A block's ``TOPR_WARPS`` warps hold
    ``tile_rows`` rows, a row a lane, ``col_split`` warps sharing a row's
    columns; each row tile is scored by one cluster of ``slices`` blocks that
    split the columns' ``col_tiles`` tiles of ``tile_cols`` between them;
    ``smem_bytes`` of shared memory a block."""

    col_split: int
    row_tiles: int
    slices: int
    tile_cols: int
    col_tiles: int
    smem_bytes: int

    @property
    def tile_rows(self) -> int:
        return TOPR_THREADS // self.col_split

    @property
    def grid(self) -> int:
        return self.row_tiles * self.slices

    def slice_tiles(self, rank: int) -> Tuple[int, int]:
        """The column tiles ``[begin, end)`` of the block of cluster rank
        ``rank`` (the kernel's partition)."""
        return (self.col_tiles * rank // self.slices,
                self.col_tiles * (rank + 1) // self.slices)

    def part_positions(self, part: int, n_cols: int, n_inst: int, begin: int,
                       end: int) -> np.ndarray:
        """The tile positions of tiles ``[begin, end)`` that warp ``part`` of a
        row scores: the kernel deals each tile's groups of positions (16 at
        one instance row, else 4) to the split's warps in turn. A position
        holds its column (one instance row) or, with several, the tile's
        columns sorted by weight, a permutation of them; the explicit-cols
        path's positions index ``cols``."""
        group = 16 if n_inst <= 1 else 4
        j = np.arange(begin * self.tile_cols, min(end * self.tile_cols, n_cols))
        return j[((j % self.tile_cols) // group) % self.col_split == part]


def topr_plan(rows: int, n_cols: int, replicas: int, n_inst: int,
              merge: bool = False) -> ToprPlan:
    """The launch of ``placement_topr`` over ``rows`` rows and ``n_cols``
    columns (all slots, or the explicit list) at ``replicas`` and ``n_inst``
    instance rows; ``merge`` when a prior is merged in.

    The tile of columns a ring stage holds is the widest power of two up to
    512 whose ring stays within 96 KB, narrowed while the columns make fewer
    than 8 tiles, so they still split into slices. Then the first column
    split W (1, 2, 4, 8) and slice count S (1, 2, 4, 8, 16) whose grid
    reaches ``TOPR_GRID`` blocks, else the largest grid (W 8, every slice).
    A wider split and more slices both cut a lane's run of columns, and so
    raise each part's admissions (the warp stops for any lane's), so the
    fewest that fill the card win; ``topr_variants.py --plans`` on an H100
    (PERF.md) puts that at four blocks an SM, and at one for the merge,
    whose prior seeds every threshold and whose explicit columns are
    gathered tile by tile. It takes the fastest plan timed there for the
    full build, the merge and the view change's rows, not for the weighted
    map (PERF.md, open questions)."""
    if not 1 <= replicas <= MAX_REPLICAS:
        raise ValueError(f"replicas {replicas} outside [1, {MAX_REPLICAS}]")
    tile_cols = TOPR_MAX_TILE
    while (tile_cols > TOPR_MIN_TILE
           and TOPR_STAGES * _topr_stage_bytes(tile_cols, n_inst) > _TOPR_RING_BUDGET):
        tile_cols //= 2
    while tile_cols > TOPR_MIN_TILE and -(-n_cols // tile_cols) < 8:
        tile_cols //= 2
    col_tiles = -(-n_cols // tile_cols)
    smem = _topr_smem(tile_cols, n_inst, replicas)
    if smem > TOPR_MAX_SMEM:
        raise ValueError(f"placement_topr: {n_inst} instances need {smem} B of shared memory")
    target = TOPR_GRID_MERGE if merge else TOPR_GRID
    plans = [ToprPlan(split, -(-rows // (TOPR_THREADS // split)), s, tile_cols, col_tiles, smem)
             for split in (1, 2, 4, 8) for s in (1, 2, 4, 8, 16)
             if s <= max(1, min(TOPR_MAX_SLICES, col_tiles))]
    return next((p for p in plans if p.grid >= target), plans[-1])


def placement_topr(
    part32: torch.Tensor, inst32: torch.Tensor, weights: torch.Tensor,
    active: Optional[torch.Tensor], replicas: int, cols: Optional[torch.Tensor] = None,
    prior: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Each row's ``replicas`` best candidates by ``(score desc, column
    asc)``, as one ``[B, 2R]`` int32 tensor: assign (``-1`` where fewer
    than R candidates exist) then the scores' uint32 bits (``split_topr``
    takes them apart on the host).

    ``part32`` int32 [B] and ``inst32`` int32 [V, C] hold uint32 keys;
    ``weights`` int32 [C] (instances with ``v >= weights[c]`` count as 0).
    Without ``cols`` every column is a candidate where the bool [C]
    ``active`` is set; with ``cols`` (int32 [M], each in [0, C): values on
    the card cannot be checked without a sync, so the kernel skips any
    other) the candidates are exactly those columns, and ``prior`` (int32 [B, 2R], a previous
    result for the same rows) is merged in. On CUDA tensors it launches ``placement_topr``
    (``csrc/placement_topr.cu``, launched as ``topr_plan`` sizes it) and
    counts the launch in ``kernels.LAUNCHES``; on CPU tensors it runs the
    plain version."""
    return _placement_topr(part32, inst32, weights, active, replicas, cols, prior)


def _placement_topr(
    part32: torch.Tensor, inst32: torch.Tensor, weights: torch.Tensor,
    active: Optional[torch.Tensor], replicas: int, cols: Optional[torch.Tensor] = None,
    prior: Optional[torch.Tensor] = None, plan: Optional[ToprPlan] = None,
) -> torch.Tensor:
    """``placement_topr``, launched on a card with ``plan`` instead of
    ``topr_plan``'s (the card tests force each regime of the plan)."""
    name = "placement_topr"
    if not 1 <= replicas <= MAX_REPLICAS:
        raise ValueError(
            f"{name}: replicas {replicas} outside [1, {MAX_REPLICAS}], the kernel's cap")
    n_rows = part32.shape[0]
    if inst32.dim() != 2 or part32.dim() != 1:
        raise ValueError(f"{name}: part32 must be [B] and inst32 [V, C]")
    n_slots = inst32.shape[1]
    for arg, t, dtype in (("part32", part32, torch.int32), ("inst32", inst32, torch.int32),
                          ("weights", weights, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
    if weights.shape != (n_slots,):
        raise ValueError(f"{name}: weights has shape {tuple(weights.shape)}, want ({n_slots},)")
    if cols is None:
        if active is None or active.dtype != torch.bool or active.shape != (n_slots,):
            raise ValueError(f"{name}: without cols, active must be bool [{n_slots}]")
    elif cols.dtype != torch.int32 or cols.dim() != 1:
        raise TypeError(f"{name}: cols must be int32 [M]")
    if prior is not None:
        if cols is None:
            raise ValueError(f"{name}: a prior is merged only with explicit cols")
        if prior.dtype != torch.int32 or prior.shape != (n_rows, 2 * replicas):
            raise ValueError(f"{name}: prior must be int32 [{n_rows}, {2 * replicas}]")
    args = [t for t in (part32, inst32, weights, active, cols, prior) if t is not None]
    if any(t.device != part32.device for t in args):
        raise ValueError(f"{name}: all inputs must be on one device")
    if part32.device.type == "cpu":
        return placement_topr_plain(part32, inst32, weights, active, replicas, cols, prior)
    if part32.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {part32.device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{name}: inputs must be contiguous")
    out = torch.empty((n_rows, 2 * replicas), dtype=torch.int32, device=part32.device)
    if n_rows == 0:
        return out
    n_cols = n_slots if cols is None else cols.shape[0]
    if plan is None:
        plan = topr_plan(n_rows, n_cols, replicas, inst32.shape[0], prior is not None)
    stream = torch.cuda.current_stream(part32.device).cuda_stream
    with profiler_range(name):
        err = kernels._function(name)(
            part32.data_ptr(), n_rows, inst32.data_ptr(), n_slots, inst32.shape[0],
            weights.data_ptr(), kernels._ptr(active, cols is None),
            kernels._ptr(cols, cols is not None), 0 if cols is None else cols.shape[0],
            kernels._ptr(prior, prior is not None), out.data_ptr(), replicas,
            plan.col_split, plan.slices, plan.tile_cols, plan.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err} ({plan})")
    kernels.LAUNCHES[name] += 1
    return out


def split_topr(out: np.ndarray, replicas: int) -> Tuple[np.ndarray, np.ndarray]:
    """A fetched ``[B, 2R]`` map -> (assign int32 [B, R], scores uint32 [B, R])."""
    out = np.ascontiguousarray(out)
    return (out[:, :replicas].copy(),
            np.ascontiguousarray(out[:, replicas:]).view(_U32).copy())


def _as_tensor(arr: np.ndarray, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device``, queued from pinned memory on a
    card so the host does not wait for it."""
    t = torch.from_numpy(np.ascontiguousarray(arr).astype(dtype, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _bits(arr: np.ndarray) -> np.ndarray:
    """uint32 keys as int32 bits (the tensors' type)."""
    return np.ascontiguousarray(arr, dtype=_U32).view(np.int32)


def topr_full(
    part32: np.ndarray,
    inst32: np.ndarray,
    weights: np.ndarray,
    active: np.ndarray,
    replicas: int,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full [P, R] build on ``device``: (assign int32, scores uint32), the
    JAX package's ``topr_full`` bit for bit."""
    return build_jit(part32, inst32, weights, active, replicas, device=device)


def build_jit(
    part32: np.ndarray,
    inst32: np.ndarray,
    weights: np.ndarray,
    active: np.ndarray,
    replicas: int,
    mesh=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The whole map in one ``placement_topr`` call, or, with a mesh (a
    ``shard.engine.Mesh``), one call a device over its block of rows; every
    row is independent, so no exchange is needed (on a mesh of several
    processes each builds the whole map on its own devices). P must divide
    by the mesh's device count, as in the JAX package. Equals the JAX package's
    ``build_jit`` except where that one cannot tell an active candidate
    whose best score is exactly 0 (p ~= 2**-32 a pair) from a masked one:
    here, as in ``topr_full``, the active candidate counts."""
    devices = (list(mesh.local_devices) if mesh is not None
               else [resolve_device(device)])
    n_parts = int(part32.shape[0])
    if n_parts % len(devices):
        raise ValueError(
            f"{n_parts} partitions do not divide over the mesh's {len(devices)} devices")
    block = n_parts // len(devices)
    outs = []
    for i, dev in enumerate(devices):
        outs.append(placement_topr(
            _as_tensor(_bits(part32[i * block:(i + 1) * block]), np.int32, dev),
            _as_tensor(_bits(inst32), np.int32, dev),
            _as_tensor(weights, np.int32, dev),
            _as_tensor(active, np.bool_, dev), replicas))
    home = devices[0]
    out = jitwatch.fetch("placement.build", torch.cat([o.to(home) for o in outs]))
    return split_topr(out, replicas)


@dataclass(frozen=True)
class DeviceDiff:
    """Array-plane PlacementDiff: moved partition indices and per-slot load
    delta, plus the old/new fingerprints for cross-plane agreement checks."""

    old_version: int
    new_version: int
    partitions_moved: np.ndarray  # int64[moved]
    load_delta: np.ndarray  # int64[C] (new slots held minus old, per slot)

    @property
    def moved(self) -> int:
        return int(self.partitions_moved.shape[0])


class DevicePlacement:
    """Stateful device-plane placement over a fixed slot universe.

    Construction fixes the candidate universe (every slot the simulator can
    ever host, alive or not), precomputes all keys on the host and uploads
    them to ``device`` once; ``build`` does the one-time full map for the
    starting active set; ``apply_view_change`` tracks churn incrementally.
    The map (``assign``, ``scores``) is kept on the host, where the handoff
    and serving planes read it: each build and each view change brings it
    back in one ``jitwatch.fetch`` labelled ``"placement.assign"``. Slot
    indices are the simulator's column indices, so candidate order -- and
    therefore tie-breaking -- is the same sorted-identity order on both
    planes when the caller's slots are sorted."""

    def __init__(
        self,
        config: PlacementConfig,
        hostnames: np.ndarray,
        host_lengths: np.ndarray,
        ports: np.ndarray,
        weights: Optional[np.ndarray] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config
        n_slots = int(ports.shape[0])
        self.replicas = min(config.replicas, n_slots)
        self.keys64 = node_keys64(hostnames, host_lengths, ports, config.seed)
        self.weights = (
            np.ones(n_slots, dtype=np.int32)
            if weights is None
            else weights.astype(np.int32)
        )
        self.inst32 = instance_keys32(self.keys64, int(self.weights.max()))
        self.part32 = partition_keys32(config.partitions, config.seed)
        self.active = np.zeros(n_slots, dtype=bool)
        self.assign: Optional[np.ndarray] = None  # [P, R] int32 slot ids
        self.scores: Optional[np.ndarray] = None  # [P, R] uint32
        self.version = 0
        self._part_dev = _as_tensor(_bits(self.part32), np.int32, self.device)
        self._upload_instances()

    def _upload_instances(self) -> None:
        self._inst_dev = _as_tensor(_bits(self.inst32), np.int32, self.device)
        self._weights_dev = _as_tensor(self.weights, np.int32, self.device)

    def _topr(self, rows: Optional[np.ndarray], active: np.ndarray) -> torch.Tensor:
        """placement_topr over ``rows`` (all when None) against the columns
        ``active`` marks, on the device; not fetched."""
        part = self._part_dev
        if rows is not None:
            part = part.index_select(0, _as_tensor(rows, np.int64, self.device))
        return placement_topr(part, self._inst_dev, self._weights_dev,
                              _as_tensor(active, np.bool_, self.device), self.replicas)

    def _fetch(self, out: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        return split_topr(jitwatch.fetch("placement.assign", out), self.replicas)

    # -- full build ------------------------------------------------------ #

    def build(self, active: np.ndarray) -> None:
        self.assign, self.scores = self._fetch(self._topr(None, active))
        self.active = active.copy()
        self.version = self._fingerprint()

    # -- incremental churn ---------------------------------------------- #

    def apply_view_change(self, new_active: np.ndarray) -> DeviceDiff:
        """Update the stored map for a new active set and return the diff.

        Rows are recomputed only when a removed slot sits in their replica
        set; added slots are merged against every surviving row's stored
        top-R. Both cases are exactly the rows rendezvous hashing says can
        change, so the moved set IS the minimal-motion set."""
        if self.assign is None:
            raise RuntimeError("build() must run before apply_view_change()")
        old_assign = self.assign
        removed = self.active & ~new_active
        added = new_active & ~self.active
        removed_slots = np.flatnonzero(removed)
        added_slots = np.flatnonzero(added)

        assign = old_assign.copy()
        scores = self.scores.copy()
        affected = (
            np.isin(old_assign, removed_slots).any(axis=1)
            if removed_slots.size
            else np.zeros(old_assign.shape[0], dtype=bool)
        )
        affected_rows = np.flatnonzero(affected)
        untouched_rows = np.flatnonzero(~affected)
        parts = []
        if affected_rows.size:
            parts.append(self._topr(affected_rows, new_active))
        if added_slots.size and untouched_rows.size:
            prior = np.concatenate(
                [assign[untouched_rows], scores[untouched_rows].view(np.int32)], axis=1)
            parts.append(placement_topr(
                self._part_dev.index_select(
                    0, _as_tensor(untouched_rows, np.int64, self.device)),
                self._inst_dev, self._weights_dev, None, self.replicas,
                cols=_as_tensor(added_slots, np.int32, self.device),
                prior=_as_tensor(prior, np.int32, self.device)))
        if parts:
            got_assign, got_scores = self._fetch(torch.cat(parts) if len(parts) > 1
                                                 else parts[0])
            n_affected = affected_rows.size
            assign[affected_rows] = got_assign[:n_affected]
            scores[affected_rows] = got_scores[:n_affected]
            if added_slots.size and untouched_rows.size:
                assign[untouched_rows] = got_assign[n_affected:]
                scores[untouched_rows] = got_scores[n_affected:]

        moved = np.flatnonzero((assign != old_assign).any(axis=1))
        old_counts = self._counts(old_assign)
        self.assign, self.scores = assign, scores
        self.active = new_active.copy()
        old_version = self.version
        self.version = self._fingerprint()
        return DeviceDiff(
            old_version=old_version,
            new_version=self.version,
            partitions_moved=moved,
            load_delta=self._counts(assign) - old_counts,
        )

    def apply_weight_change(self, new_weights: np.ndarray) -> DeviceDiff:
        """Re-derive the map after capacity weights change for existing
        members: a full rebuild over the current active set (weights feed
        every candidate's instance keys, so no smaller row set can change),
        as the engine's ``update`` with changed weights rebuilds in full."""
        if self.assign is None:
            raise RuntimeError("build() must run before apply_weight_change()")
        new_weights = new_weights.astype(np.int32)
        if new_weights.shape != self.weights.shape:
            raise ValueError("weights must cover the full slot universe")
        old_assign = self.assign
        old_counts = self._counts(old_assign)
        old_version = self.version
        self.weights = new_weights
        self.inst32 = instance_keys32(self.keys64, int(new_weights.max()))
        self._upload_instances()
        self.assign, self.scores = self._fetch(self._topr(None, self.active))
        self.version = self._fingerprint()
        moved = np.flatnonzero((self.assign != old_assign).any(axis=1))
        return DeviceDiff(
            old_version=old_version,
            new_version=self.version,
            partitions_moved=moved,
            load_delta=self._counts(self.assign) - old_counts,
        )

    # -- introspection --------------------------------------------------- #

    def _counts(self, assign: np.ndarray) -> np.ndarray:
        flat = assign[assign >= 0]
        return np.bincount(flat, minlength=self.keys64.shape[0]).astype(np.int64)

    def counts(self) -> np.ndarray:
        if self.assign is None:
            return np.zeros(self.keys64.shape[0], dtype=np.int64)
        return self._counts(self.assign)

    def imbalance(self) -> float:
        """Same statistic as PlacementMap.imbalance over the active slots."""
        if self.assign is None or not self.active.any():
            return 0.0
        counts = self.counts()[self.active]
        weights = self.weights[self.active].astype(np.float64)
        total_slots = float(self.assign.size)
        fair = total_slots / float(weights.sum())
        if fair == 0.0:
            return 0.0
        return float((counts / weights).max() / fair)

    def _fingerprint(self) -> int:
        """engine._fingerprint mirror: xxh64 over the assigned node keys,
        8 LE bytes each, in partition-major order. Defined when every slot
        is filled (active count >= R), which the engine parity requires
        anyway. One long input: the scalar hash walks it 25x faster than
        the batched one, which vectorizes across inputs, not along one."""
        keys = np.where(
            self.assign >= 0,
            self.keys64[np.clip(self.assign, 0, None)],
            _U64(0),
        )
        return to_signed(xxh64(keys.astype("<u8").tobytes(), self.config.seed))
