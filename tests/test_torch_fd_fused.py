"""The fused FD phase of the PyTorch port (``kernels.fd_phase_fused``): its
plain version against the JAX engine's ``_fd_phase`` and against a numpy
reference, the CPU path of its wrapper, and, on an NVIDIA GPU, the CUDA
kernel against its plain version under both FD policies (the windowed
policy's plain version is held against JAX in tests/test_torch_windowed.py). Exact equality throughout: the phase is
integer and boolean only, and where a random draw enters, both sides read
the same draw (or a drop probability of 0 or 1, where the draw cannot
matter).

JAX is imported only inside the JAX comparisons, so the CUDA tests also run
where JAX is not installed (see tests/test_torch_cuda.py for the command)."""

import dataclasses

import numpy as np
import pytest
import torch

from rapid_tpu_torch.sim import engine, kernels

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
