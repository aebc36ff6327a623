"""The fused FD phase of the PyTorch port (``kernels.fd_phase_fused``): its
plain version against the JAX engine's ``_fd_phase`` and against a numpy
reference, the CPU path of its wrapper, and, on an NVIDIA GPU, the CUDA
kernel against its plain version under both FD policies (the windowed
policy's plain version is held against JAX in tests/test_torch_windowed.py).
Then its split around the multi-device alert exchange: ``fd_phase_rows``
over row blocks (one call a shard, or one call over every shard of a
device, halted or not) followed by ``fd_gather`` equals the fused phase, in
plain versions on the CPU and in the kernels on the card; the gather's
multiply-shift reciprocal is exact. Exact equality
throughout: the phase is integer and boolean only, and where a random draw
enters, both sides read the same draw (or a drop probability of 0 or 1,
where the draw cannot matter).

JAX is imported only inside the JAX comparisons, so the CUDA tests also run
where JAX is not installed (see tests/test_torch_cuda.py for the command)."""

import dataclasses

import numpy as np
import pytest
import torch

from rapid_tpu_torch.sim import engine, fd_bench, kernels

OUTPUTS = ("alive", "fd_fail", "alerted", "fd_streak", "fd_ok", "down_arrivals")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# --------------------------------------------------------------------- #
# Against the JAX engine
# --------------------------------------------------------------------- #

BASE = dict(capacity=64, k=10, h=9, l=4, fd_threshold=3)


def _jax_case(overrides, setup, n_nodes=60, seed=3, round_=0, seed_counters=None):
    """A JAX simulator's state and fault plane after ``setup``, with the
    per-edge counters and latches seeded from numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from rapid_tpu.sim import engine as jeng
    from rapid_tpu.sim.driver import Simulator as JaxSimulator

    config = jeng.SimConfig(**{**BASE, **overrides})
    sim = JaxSimulator(n_nodes, capacity=config.capacity, config=config, seed=seed,
                       speculate=False)
    extra = setup(sim) or {}
    rng = np.random.default_rng(seed)
    c, k = config.capacity, config.k
    lo, hi = seed_counters or (0, config.fd_threshold + 1)
    state = dataclasses.replace(
        sim.state,
        fd_fail=jnp.asarray(rng.integers(lo, hi, (c, k)).astype(np.uint8)),
        fd_streak=jnp.asarray(rng.integers(lo, min(hi, 256), (c, k)).astype(np.uint8)),
        fd_ok=jnp.asarray(rng.integers(lo if seed_counters else 0, 256, (c, k)).astype(np.uint8)),
        alerted=jnp.asarray(rng.random((c, k)) < 0.1),
        round=jnp.int32(round_),
    )
    return config, state, jeng.const_inputs(config, sim.alive, **extra)


def _assert_matches_jax(config, state, inputs, random_loss=False):
    from rapid_tpu.sim import engine as jeng

    out = jeng._fd_phase(config, state, inputs, random_loss)
    want = dict(zip(OUTPUTS, (out[2], out[3], out[8], out[6], out[7], out[9])))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    draw = None
    if random_loss:
        # drop probabilities are 0 or 1 here, so any draw in [0, 1) decides
        # exactly as threefry's does
        draw = torch.from_numpy(
            np.random.default_rng(0).random((config.capacity, config.k)).astype(np.float32)
        )
    got = kernels.fd_phase_fused_plain(
        t(state.active), t(inputs.alive), t(inputs.drop_prob), t(state.subjects),
        t(state.observers), t(inputs.probe_drop), t(inputs.down_reports), draw,
        t(state.fd_fail), t(state.alerted), t(state.fd_streak), t(state.fd_ok),
        t(state.round), threshold=config.fd_threshold,
        gray_confirm=config.fd_gray_confirm, gray_warmup=config.fd_gray_warmup,
        rounds_per_interval=config.rounds_per_interval,
    )
    for name, g in zip(OUTPUTS, got):
        w = np.asarray(want[name])
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return want


def _crash(sim):
    sim.crash(np.array([6, 21, 40]))


def _one_way(sim):
    sim.one_way_ingress_partition(np.array([4, 9]))
    return {"probe_drop": sim._probe_drop_mask()}


def _joiners_and_leavers(sim):
    sim.crash(np.array([10]))
    sim.leave(np.array([3, 28]))
    sim.request_joins(np.array([60, 61, 62]))
    joins = sim._arm_pending_joins()  # writes the joiners' expected observers
    return {"down_reports": np.asarray(sim._down_reports()), "join_reports": joins}


def _lossy(sim):
    sim.crash(np.array([7]))
    drop = np.zeros(sim.config.capacity, dtype=np.float32)
    drop[[2, 30, 44]] = 1.0
    return {"drop_prob": drop}


def test_fused_plain_matches_jax_crash():
    want = _assert_matches_jax(*_jax_case({}, _crash))
    assert np.asarray(want["down_arrivals"]).any(), "the case should raise alerts"


def test_fused_plain_matches_jax_one_way_probe_drop():
    _assert_matches_jax(*_jax_case({}, _one_way))


@pytest.mark.parametrize("round_", range(6))
def test_fused_plain_matches_jax_staggered_phases(round_):
    _assert_matches_jax(*_jax_case({"rounds_per_interval": 4}, _crash, round_=round_))


def test_fused_plain_matches_jax_gray_streak():
    config, state, inputs = _jax_case(
        {"fd_gray_confirm": 3, "fd_gray_warmup": 3, "fd_threshold": 8}, _crash,
        seed_counters=(0, 6),
    )
    want = _assert_matches_jax(config, state, inputs)
    gray_only = np.asarray(want["alerted"]) & ~np.asarray(state.alerted) & (
        np.asarray(want["fd_fail"]) < config.fd_threshold
    )
    assert gray_only.any(), "some edges should fire on the streak alone"


def test_fused_plain_matches_jax_joiner_rows_and_down_reports():
    config, state, inputs = _jax_case({}, _joiners_and_leavers)
    assert np.asarray(inputs.down_reports).any()
    assert not np.asarray(state.active)[60:63].any(), "joiner rows are inactive"
    _assert_matches_jax(config, state, inputs)


@pytest.mark.parametrize("gray", [0, 3])
def test_fused_plain_matches_jax_saturated_counters(gray):
    config, state, inputs = _jax_case(
        {"fd_threshold": 253, "fd_gray_confirm": gray, "fd_gray_warmup": 250}, _crash,
        seed_counters=(250, 256),
    )
    want = _assert_matches_jax(config, state, inputs)
    assert int(np.asarray(want["fd_fail"]).max()) == 255


def test_fused_plain_matches_jax_random_loss_at_probability_zero_and_one():
    _assert_matches_jax(*_jax_case({}, _lossy), random_loss=True)


# --------------------------------------------------------------------- #
# Against a numpy reference, and the wrapper's CPU path
# --------------------------------------------------------------------- #


def _case(c, k, seed, device="cpu", random=True, joiners=True, round_=None):
    """State and fault plane of one round at [c, k], the adjacency from
    ``engine.device_initial_state`` over random ring orders, counters and
    latches seeded from numpy. Returns the wrapper's positional inputs."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    config = engine.SimConfig(capacity=c, k=k)
    active = torch.from_numpy(rng.random(c) < 0.95).to(dev)
    ranks = torch.from_numpy(
        np.stack([rng.permutation(c) for _ in range(k)]).astype(np.int32)).to(dev)
    state = engine.device_initial_state(
        config, ranks, active, active.clone(), torch.zeros(c, dtype=torch.int32, device=dev),
        torch.ones(c, dtype=torch.bool, device=dev),
    )
    observers = state.observers
    if joiners:  # inactive rows hold expected observers, as after a join wave
        inactive = (~active).nonzero().flatten()
        observers = observers.clone()
        observers[inactive] = torch.from_numpy(
            rng.integers(0, c, (len(inactive), k)).astype(np.int32)).to(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (
        active, t(rng.random(c) < 0.97),
        t(rng.choice([0.0, 0.25, 0.5, 1.0], c).astype(np.float32)),
        state.subjects, observers, t(rng.random((c, k)) < 0.05),
        t(rng.random((c, k)) < 0.02),
        t(rng.random((c, k)).astype(np.float32)) if random else None,
        t(rng.integers(0, 256, (c, k)).astype(np.uint8)), t(rng.random((c, k)) < 0.1),
        t(rng.integers(0, 256, (c, k)).astype(np.uint8)),
        t(rng.integers(0, 256, (c, k)).astype(np.uint8)),
        torch.tensor(int(rng.integers(0, 100)) if round_ is None else round_,
                     dtype=torch.int32, device=dev),
    )


def _reference(args, threshold, gray_confirm, gray_warmup, rpi):
    (active, alive, drop_prob, subjects, observers, probe_drop, down_reports, draw,
     fd_fail, alerted, fd_streak, fd_ok, round_) = (
        None if a is None else a.cpu().numpy() for a in args)
    c, k = subjects.shape
    alive = alive & active
    phase = ((np.arange(c, dtype=np.uint64) * 2654435761) % 2**32) % rpi
    up = alive & (phase == int(round_) % rpi)
    watching = active[:, None] & active[subjects] & up[:, None]
    ok = alive[subjects] & ~probe_drop
    if draw is not None:
        ok &= ~(draw < drop_prob[subjects])
    fail = watching & ~ok
    fd = np.minimum(fd_fail.astype(np.int32) + fail, 255).astype(np.uint8)
    down = watching & (fd >= threshold) & ~alerted
    if gray_confirm:
        ok_event = watching & ok
        streak = np.where(ok_event, 0, np.minimum(fd_streak.astype(np.int32) + fail, 255))
        down |= fail & (streak >= gray_confirm) & (fd_ok >= gray_warmup) & ~alerted
        fd_ok = np.minimum(fd_ok.astype(np.int32) + ok_event, 255).astype(np.uint8)
        fd_streak = streak.astype(np.uint8)
    arrivals = (down[observers, np.arange(k)[None, :]] | down_reports) & active[:, None]
    return alive, fd, alerted | down, fd_streak, fd_ok, arrivals


@pytest.mark.parametrize("gray, rpi", [(0, 1), (3, 1), (0, 4), (4, 4)])
def test_fused_plain_matches_numpy_reference_with_shared_draw(gray, rpi):
    args = _case(500, 10, seed=gray * 10 + rpi)
    kw = dict(threshold=10, gray_confirm=gray, gray_warmup=40, rounds_per_interval=rpi)
    got = kernels.fd_phase_fused_plain(*args, **kw)
    want = _reference(args, 10, gray, 40, rpi)
    for name, g, w in zip(OUTPUTS, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[5].any() and (got[2] != args[9]).any()


def test_fused_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    args = _case(200, 10, seed=1)
    kw = dict(threshold=10, gray_confirm=3, gray_warmup=3, rounds_per_interval=2)
    before = dict(kernels.LAUNCHES)
    got = kernels.fd_phase_fused(*args, **kw)
    want = kernels.fd_phase_fused_plain(*args, **kw)
    for name, g, w in zip(OUTPUTS, got, want):
        assert torch.equal(g, w), name
    assert kernels.LAUNCHES == before


def test_fused_wrapper_rejects_bad_arguments():
    args = list(_case(32, 10, seed=2))
    kw = dict(threshold=10)
    wide = list(args)
    wide[3] = args[3].long()  # int64 subjects
    with pytest.raises(TypeError):
        kernels.fd_phase_fused(*wide, **kw)
    wide = list(args)
    wide[4] = args[4].long()  # int64 observers
    with pytest.raises(TypeError):
        kernels.fd_phase_fused(*wide, **kw)
    short = list(args)
    short[5] = args[5][:16]
    with pytest.raises(ValueError):
        kernels.fd_phase_fused(*short, **kw)
    with pytest.raises(ValueError):
        kernels.fd_phase_fused(*args, threshold=0)



def test_scan_round_goes_through_the_fused_wrapper(monkeypatch):
    """``engine.step`` hands the state's int32 adjacency and its round
    counter to ``fd_phase_fused``, and draws only with random loss."""
    calls = []
    real = kernels.fd_phase_fused

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(kernels, "fd_phase_fused", spy)
    from rapid_tpu_torch.sim.driver import Simulator

    config = engine.SimConfig(capacity=64, rounds_per_interval=2)
    state = Simulator(64, config=config, seed=1, device="cpu").state
    inputs = engine.const_inputs(config, np.ones(64, dtype=bool), device="cpu")
    gen = torch.Generator().manual_seed(0)
    engine.step(config, state, inputs, random_loss=True, generator=gen)
    engine.step(config, state, inputs, random_loss=False)
    assert len(calls) == 2
    (args, kw), (args2, _) = calls
    assert args[3] is state.subjects and args[4] is state.observers
    assert args[3].dtype == torch.int32 and args[12] is state.round
    assert args[7] is not None and args2[7] is None
    assert kw["rounds_per_interval"] == 2 and kw["threshold"] == config.fd_threshold


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #


def _assert_kernel_matches_plain(args, kw, counter="fd_phase_fused"):
    before = dict(kernels.LAUNCHES)
    got = kernels.fd_phase_fused(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**before, counter: before[counter] + 1}
    want = kernels.fd_phase_fused_plain(*args, **kw)
    for name, g, w in zip(OUTPUTS + ("fd_hist", "fd_seen"), got, want):
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("gray, rpi, random", [
    (0, 1, True), (3, 4, True), (0, 4, False), (3, 1, False),
])
@pytest.mark.parametrize("c", [1, 333, 100_000, 1_000_000])
def test_cuda_fused_kernel_matches_plain(cuda_device, c, gray, rpi, random):
    args = _case(c, 10, seed=c + gray + rpi, device=cuda_device, random=random)
    kw = dict(threshold=10, gray_confirm=gray, gray_warmup=3, rounds_per_interval=rpi)
    _assert_kernel_matches_plain(args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_cuda_fused_kernel_on_misaligned_slices(cuda_device, offset):
    """Every [C,K] input a contiguous slice that starts ``offset`` elements
    into its buffer, over a flat length (3330) that is no multiple of 16."""
    args = list(_case(333, 10, seed=offset, device=cuda_device))
    for i, a in enumerate(args):
        if a is not None and a.dim() == 2:
            buf = torch.zeros(a.numel() + offset, dtype=a.dtype, device=a.device)
            view = buf[offset:].view(a.shape)
            view.copy_(a)
            assert view.is_contiguous() and view.data_ptr() % 16 != 0
            args[i] = view
    kw = dict(threshold=10, gray_confirm=3, gray_warmup=3, rounds_per_interval=1)
    _assert_kernel_matches_plain(args, kw)


def _window_kw(c, k, w, frac, rpi, seed, device):
    """Windowed-policy arguments: partly filled windows from numpy, t by the
    engine's float64 rounding."""
    rng = np.random.default_rng(seed)
    bits = rng.random((c, k, w)) < 0.5
    hist = (bits << np.arange(w)).sum(axis=-1).astype(np.int32)
    seen = np.where(rng.random((c, k)) < 0.5, w, rng.integers(0, w + 1, (c, k))).astype(np.uint8)
    config = engine.SimConfig(capacity=c, fd_policy="windowed", fd_window=w,
                              fd_window_threshold=frac)
    return dict(threshold=10, rounds_per_interval=rpi, window=w,
                window_fire=engine.window_params(config)[1],
                fd_hist=torch.from_numpy(hist).to(device),
                fd_seen=torch.from_numpy(seen).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("w, frac, rpi, random", [
    (10, 0.4, 1, True), (16, 0.7, 4, True), (10, 0.7, 4, False), (16, 0.4, 1, False),
    (1, 1.0, 1, True),
])
@pytest.mark.parametrize("c", [1, 333, 100_000])
def test_cuda_windowed_kernel_matches_plain(cuda_device, c, w, frac, rpi, random):
    args = _case(c, 10, seed=c + w + rpi, device=cuda_device, random=random)
    kw = _window_kw(c, 10, w, frac, rpi, seed=c * w, device=cuda_device)
    got = _assert_kernel_matches_plain(args, kw, "fd_phase_fused_windowed")
    assert got[1] is args[8]  # fd_fail passes through untouched


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_cuda_windowed_kernel_on_misaligned_slices(cuda_device, offset):
    """As the cumulative case above, with fd_hist and fd_seen misaligned too."""
    args = list(_case(333, 10, seed=offset, device=cuda_device))
    kw = _window_kw(333, 10, 10, 0.4, 1, seed=offset, device=cuda_device)
    for i, a in enumerate(args):
        if a is not None and a.dim() == 2:
            args[i] = _misaligned(a, offset)
    kw["fd_hist"], kw["fd_seen"] = _misaligned(kw["fd_hist"], offset), _misaligned(kw["fd_seen"], offset)
    _assert_kernel_matches_plain(args, kw, "fd_phase_fused_windowed")


def _misaligned(a, offset):
    buf = torch.zeros(a.numel() + offset, dtype=a.dtype, device=a.device)
    view = buf[offset:].view(a.shape)
    view.copy_(a)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
def test_cuda_fused_wrapper_rejects_int64_and_non_contiguous(cuda_device):
    args = list(_case(64, 10, seed=0, device=cuda_device))
    wide = list(args)
    wide[3] = args[3].long()
    with pytest.raises(TypeError):
        kernels.fd_phase_fused(*wide, threshold=10)
    strided = list(args)
    strided[8] = args[8].t().contiguous().t()
    with pytest.raises(ValueError):
        kernels.fd_phase_fused(*strided, threshold=10)


# --------------------------------------------------------------------- #
# The split around the alert exchange: fd_phase_rows + fd_gather
# --------------------------------------------------------------------- #

# (policy keyword arguments; gray and staggered phases; the window)
POLICIES = {
    "cumulative": dict(threshold=10),
    "gray": dict(threshold=10, gray_confirm=3, gray_warmup=3, rounds_per_interval=4),
    "windowed": dict(threshold=10, window=10, rounds_per_interval=2),
}
# capacities and shard counts: misaligned row blocks (333 / 3: rows of 1110
# edges start off a 16-edge slot) and partial last words (1000 / 8: 1250
# edges, 1250 mod 32 = 2)
SPLITS = [(64, 1), (64, 4), (64, 8), (333, 3), (333, 9), (1000, 5), (1000, 8)]


def _policy_kw(policy, c, seed, device):
    kw = dict(POLICIES[policy])
    if policy == "windowed":
        kw = dict(_window_kw(c, 10, 10, 0.4, kw["rounds_per_interval"], seed, device),
                  threshold=10)
    return kw


def _split_phase(args, kw, shards, kernel=False, per_device=True, **extra):
    """``fd_phase_rows`` over ``shards`` row blocks into one bitset, in one
    call over every shard (``per_device``) or one a shard, then
    ``fd_gather`` (``fd_bench.split_case``, ``fd_bench.run_split``): the
    kernels with ``kernel``, else the plain versions. Returns the fused
    phase's eight outputs (``alive`` as None) and the bitset."""
    calls, bits = fd_bench.split_case(args, kw, shards)
    return fd_bench.run_split(calls, bits, args, kernel, per_device, **extra), bits


def _assert_split_equals_fused(args, kw, shards, kernel=False, per_device=True):
    got, bits = _split_phase(args, kw, shards, kernel, per_device)
    want = kernels.fd_phase_fused_plain(*args, **kw)
    for name, g, w in zip(OUTPUTS + ("fd_hist", "fd_seen"), got, want):
        if name == "alive":
            continue
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    return got, bits


@pytest.mark.parametrize("per_device", [False, True])
@pytest.mark.parametrize("random", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("c, shards", SPLITS)
def test_split_plain_equals_fused_plain(c, shards, policy, random, per_device):
    """One plain call a shard, or one plain call over every shard."""
    args = _case(c, 10, seed=c + shards, random=random)
    kw = _policy_kw(policy, c, seed=c * shards, device="cpu")
    got, bits = _assert_split_equals_fused(args, kw, shards, per_device=per_device)
    assert (got[2] & ~args[9]).any(), "the case should raise alerts"
    other, other_bits = _split_phase(args, kw, shards, per_device=not per_device)
    assert torch.equal(bits, other_bits)
    for g, w in zip(got, other):
        assert (g is None and w is None) or torch.equal(g, w)


def _assert_halted(args, kw, shards, kernel=False, alerts=True):
    """A halted call over every shard: each plane as it came in, every
    segment (padding and flag included) zero; with ``alerts`` the same call
    not halted raises some. Returns the halted planes and bitset."""
    calls, bits = fd_bench.split_case(args, kw, shards)
    merged, merged_kw = fd_bench.device_call(calls)
    rows_fn = kernels.fd_phase_rows if kernel else kernels.fd_phase_rows_plain
    halt = torch.tensor(True, device=args[0].device)
    outs = rows_fn(*merged, **merged_kw, halt=halt)
    assert len(outs) == shards
    for (a, a_kw), out in zip(calls, outs):
        planes_in = (a[6], a[7], a[8], a[9], a_kw["fd_hist"], a_kw["fd_seen"])
        for name, i, o in zip(("fd_fail", "alerted", "fd_streak", "fd_ok", "fd_hist",
                               "fd_seen"), planes_in, out):
            assert (i is None and o is None) or (o.dtype == i.dtype and torch.equal(o, i)), name
    halted = bits.clone()
    assert not halted.any()
    rows_fn(*merged, **merged_kw, halt=~halt)
    words = kernels.segment_words(args[3].shape[0] // shards, 10)
    assert bits.view(shards, words)[:, -1].any() or not alerts, "the call should raise alerts"
    return outs, halted


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("c, shards", [(64, 1), (333, 3), (1000, 8)])
def test_halted_rows_call_leaves_planes_and_writes_no_bit(c, shards, policy):
    args = _case(c, 10, seed=c + shards)
    _assert_halted(args, _policy_kw(policy, c, seed=c * shards, device="cpu"), shards)


@pytest.mark.parametrize("c", [1, 333, 1000, 100_000, 1_000_000])
def test_gather_reciprocal_is_exact(c):
    """``row_reciprocal`` finds the shard of every observer o < C for every
    shard size that tiles C, as the kernel computes it: a 32-bit 2o, the
    high word of its product with the magic number, a shift."""
    o = np.arange(c, dtype=np.uint64)
    for rows in (d for d in range(1, c + 1) if c % d == 0):
        magic, shift = kernels.row_reciprocal(rows)
        assert 0 < magic < 1 << 32
        got = ((2 * o * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
        np.testing.assert_array_equal(got, o // rows, err_msg=f"C {c}, rows {rows}")


def test_gather_reciprocal_at_the_int32_edge():
    """Observers up to 2**31 - 1 and shard sizes up to 2**31."""
    o = np.concatenate([np.arange(1 << 16), (1 << 31) - 1 - np.arange(1 << 16),
                        np.random.default_rng(0).integers(0, 1 << 31, 1 << 16)]).astype(np.uint64)
    sizes = [1, 2, 3, 5, 7, 10, 12_500, 65_537, (1 << 31) // 10, (1 << 30) + 1,
             (1 << 31) - 1, 1 << 31]
    for rows in sizes:
        magic, shift = kernels.row_reciprocal(rows)
        assert 0 < magic < 1 << 32
        got = ((2 * o * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
        np.testing.assert_array_equal(got, o // np.uint64(rows), err_msg=f"rows {rows}")
    for bad in (0, (1 << 31) + 1):
        with pytest.raises(ValueError):
            kernels.row_reciprocal(bad)


@pytest.mark.parametrize("c, shards", [(333, 3), (1000, 8)])
def test_split_plain_quiet_round_sets_no_flag(c, shards):
    """No edge crosses: every segment's flag is 0, and the gather reads no
    bit (down_arrivals is the down reports of active destinations)."""
    args = list(_case(c, 10, seed=5))
    args[8] = torch.zeros_like(args[8])  # no counter near the threshold
    got, bits = _assert_split_equals_fused(tuple(args), dict(threshold=10), shards)
    words = kernels.segment_words(c // shards, 10)
    assert not bits.view(shards, words)[:, -1].any()
    assert torch.equal(got[5], args[6] & args[0][:, None])


def test_segment_layout_is_lsb_first_words_and_a_flag():
    rng = np.random.default_rng(3)
    new_down = rng.random((37, 10)) < 0.1
    seg = kernels.pack_segment(torch.from_numpy(new_down))
    assert seg.dtype == torch.int32 and seg.shape == (kernels.segment_words(37, 10),)
    want = np.packbits(np.concatenate([new_down.reshape(-1), np.zeros(14, bool)]),
                       bitorder="little").view("<i4")
    np.testing.assert_array_equal(seg[:-1].numpy(), want)
    assert int(seg[-1]) == 1
    assert int(kernels.pack_segment(torch.zeros(37, 10, dtype=torch.bool))[-1]) == 0


def test_split_wrappers_take_plain_path_on_cpu_and_check_arguments():
    args = _case(64, 10, seed=9)
    before = dict(kernels.LAUNCHES)
    _assert_split_equals_fused(args, dict(threshold=10), 4, kernel=True)
    assert kernels.LAUNCHES == before
    words = kernels.segment_words(16, 10)
    bits = torch.zeros(4 * words, dtype=torch.int32)
    block = [None if a is None or a.dim() != 2 else a[:16].clone() for a in args]
    row_args = (args[0], args[1], args[2], block[3], block[5], block[7], block[8], block[9],
                block[10], block[11], args[12])
    with pytest.raises(ValueError, match="outside"):
        kernels.fd_phase_rows(*row_args, bits[:words], row0=50, threshold=10)
    with pytest.raises(ValueError, match="bits"):
        kernels.fd_phase_rows(*row_args, bits[:words - 1], row0=0, threshold=10)
    with pytest.raises(TypeError):
        kernels.fd_phase_rows(*row_args, bits[:words].long(), row0=0, threshold=10)
    with pytest.raises(ValueError, match="tile"):
        kernels.fd_gather(args[0], args[4], args[6], bits, 15)
    with pytest.raises(ValueError, match="bits"):
        kernels.fd_gather(args[0], args[4], args[6], bits[1:], 16)


def test_per_device_wrapper_checks_its_shards():
    """A call over several shards: one value a shard in every per-shard
    argument, all shards drawing or none, at most MAX_SHARDS_PER_CALL, no
    empty shard, and a 0-d bool halt."""
    args = _case(64, 10, seed=9)
    calls, _ = fd_bench.split_case(args, dict(threshold=10), 4)
    merged, kw = fd_bench.device_call(calls)
    kernels.fd_phase_rows(*merged, **kw)
    short = list(merged)
    short[3] = merged[3][:3]  # three subjects blocks for four shards
    with pytest.raises(ValueError, match="subjects"):
        kernels.fd_phase_rows(*short, **kw)
    mixed = list(merged)
    mixed[5] = [None] + merged[5][1:]  # one shard without its draw
    with pytest.raises(ValueError, match="draws"):
        kernels.fd_phase_rows(*mixed, **kw)
    with pytest.raises(TypeError):
        kernels.fd_phase_rows(*merged, **kw, halt=torch.tensor(1))
    with pytest.raises(ValueError, match="halt"):
        kernels.fd_phase_rows(*merged, **kw, halt=torch.tensor([True]))
    many = fd_bench.split_case(args, dict(threshold=10), 32)[0]
    merged, kw = fd_bench.device_call(many[:kernels.MAX_SHARDS_PER_CALL + 1])
    with pytest.raises(ValueError, match="at most"):
        kernels.fd_phase_rows(*merged, **kw)
    empty = list(fd_bench.device_call(calls[:1])[0])
    for i in (3, 4, 5, 6, 7, 8, 9):
        empty[i] = [empty[i][0][:0]]
    empty[11] = [torch.zeros(1, dtype=torch.int32)]
    with pytest.raises(ValueError, match="empty"):
        kernels.fd_phase_rows(*empty, row0=[0], threshold=10)


CUDA_SPLITS = [(1, 1), (333, 3), (333, 9), (1000, 8), (100_000, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("halted", [False, True])
@pytest.mark.parametrize("random", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("c, shards", CUDA_SPLITS)
def test_cuda_split_kernels_match_plain(cuda_device, c, shards, policy, random, halted):
    """The per-device fd_phase_rows over every shard and the gather against
    their plain versions (the whole bitset included, flag and padding), and
    the split against the fused phase; halted, every plane as it came in and
    no bit. One launch a call."""
    args = _case(c, 10, seed=c + shards, device=cuda_device, random=random)
    kw = _policy_kw(policy, c, seed=c * shards, device=cuda_device)
    counter = "fd_phase_rows_windowed" if policy == "windowed" else "fd_phase_rows"
    before = dict(kernels.LAUNCHES)
    if halted:
        got, bits = _assert_halted(args, kw, shards, kernel=True, alerts=c > 1)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {**before, counter: before[counter] + 2}
        calls, want_bits = fd_bench.split_case(args, kw, shards)
        merged, merged_kw = fd_bench.device_call(calls)
        want = kernels.fd_phase_rows_plain(*merged, **merged_kw,
                                           halt=torch.tensor(True, device=cuda_device))
        assert torch.equal(bits, want_bits)
        for g_shard, w_shard in zip(got, want):
            for g, w in zip(g_shard, w_shard):
                assert (g is None and w is None) or torch.equal(g, w)
        return
    got, bits = _assert_split_equals_fused(args, kw, shards, kernel=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**before, counter: before[counter] + 1,
                                "fd_gather": before["fd_gather"] + 1}
    want, want_bits = _split_phase(args, kw, shards)
    assert torch.equal(bits, want_bits)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("c, shards", CUDA_SPLITS)
def test_cuda_gather_matches_plain(cuda_device, c, shards, quiet):
    """fd_gather alone against its plain version, from bitsets the plain
    split writes: every segment's bits random (flags set), or every flag 0."""
    args = _case(c, 10, seed=c * 7 + shards, device=cuda_device)
    rows, words = c // shards, kernels.segment_words(c // shards, 10)
    rng = np.random.default_rng(c + shards)
    new_down = torch.from_numpy(rng.random((c, 10)) < 0.3).to(cuda_device)
    bits = torch.cat([kernels.pack_segment(new_down[s * rows:(s + 1) * rows] & (not quiet))
                      for s in range(shards)])
    assert bits.shape == (shards * words,)
    got = kernels.fd_gather(args[0], args[4], args[6], bits, rows)
    want = kernels.fd_gather_plain(args[0], args[4], args[6], bits, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_cuda_rows_kernel_on_misaligned_blocks(cuda_device, offset):
    """Row blocks that start ``offset`` elements into their buffers take the
    scalar path, in a call over all three shards and in one call a shard;
    the segments and the planes still match the plain version."""
    args = _case(333, 10, seed=offset, device=cuda_device)
    kw = dict(threshold=10, gray_confirm=3, gray_warmup=3, rounds_per_interval=1)
    rows, words = 111, kernels.segment_words(111, 10)
    blocks = [[None if a is None or a.dim() != 2 else
               _misaligned(a[s * rows:(s + 1) * rows], offset) for a in args] for s in range(3)]
    per_shard = [(b[3], b[5], b[7], b[8], b[9], b[10], b[11]) for b in blocks]
    merged = (args[0], args[1], args[2], *(list(col) for col in zip(*per_shard)), args[12])
    got_bits = torch.full((3 * words,), -1, dtype=torch.int32, device=cuda_device)
    want_bits = torch.zeros(3 * words, dtype=torch.int32, device=cuda_device)
    segments = [list(bits.split(words)) for bits in (got_bits, want_bits)]
    got = kernels.fd_phase_rows(*merged, segments[0], row0=[0, rows, 2 * rows], **kw)
    want = kernels.fd_phase_rows_plain(*merged, segments[1], row0=[0, rows, 2 * rows], **kw)
    for s in range(3):
        one_bits = torch.full((words,), -1, dtype=torch.int32, device=cuda_device)
        one = kernels.fd_phase_rows(args[0], args[1], args[2], *per_shard[s], args[12],
                                    one_bits, row0=s * rows, **kw)
        torch.cuda.synchronize()
        assert torch.equal(one_bits, want_bits[s * words:(s + 1) * words])
        for g, o, w in zip(got[s], one, want[s]):
            assert (g is None and w is None) or (torch.equal(g, w) and torch.equal(o, w))
    assert torch.equal(got_bits, want_bits)
