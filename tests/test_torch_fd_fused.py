"""The fused FD phase of the PyTorch port (``kernels.fd_phase_fused``): its
plain version against the JAX engine's ``_fd_phase`` and against a numpy
reference, the CPU path of its wrapper, and, on an NVIDIA GPU, the CUDA
kernel against its plain version under both FD policies (the windowed
policy's plain version is held against JAX in tests/test_torch_windowed.py).
Then its split around the multi-device alert exchange: ``fd_phase_rows``
over row blocks (one call a shard, or one call over every shard of a
device, halted or not) followed by ``fd_gather`` equals the fused phase, in
plain versions on the CPU and in the kernels on the card; the gather's
multiply-shift reciprocal is exact. Every call also splits the state's
random key (the new key compared too, kept as it came when halted), and
under random loss draws JAX's threefry bits (``threefry.draw_plain``'s
block; the kernels draw only where a word can change an outcome, a rule
held edge by edge against the block); each shard of the split draws under
the probe key folded with its index, as on a mesh.
Exact equality throughout: the phase is integer and boolean only, and
where a random draw enters, both sides draw the same bits: against JAX, the
round's own threefry draw from the state's key, at any drop probability.

JAX is imported only inside the JAX comparisons, so the CUDA tests also run
where JAX is not installed (see tests/test_torch_cuda.py for the command)."""

import dataclasses

import numpy as np
import pytest
import torch

from rapid_tpu_torch.sim import engine, fd_bench, fd_variants, kernels, threefry

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

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
    got = kernels.fd_phase_fused_plain(
        t(state.active), t(inputs.alive), t(inputs.drop_prob) if random_loss else None,
        t(state.subjects), t(state.observers), t(inputs.probe_drop), t(inputs.down_reports),
        t(state.rng_key).long(), t(state.fd_fail), t(state.alerted), t(state.fd_streak),
        t(state.fd_ok), t(state.round), threshold=config.fd_threshold,
        gray_confirm=config.fd_gray_confirm, gray_warmup=config.fd_gray_warmup,
        rounds_per_interval=config.rounds_per_interval,
    )
    for name, g in zip(OUTPUTS, got):
        w = np.asarray(want[name])
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the split key JAX's round returns, with loss or without
    np.testing.assert_array_equal(got[8].numpy().astype(np.uint32), np.asarray(out[0]),
                                  err_msg="key")
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


def _half_lossy(sim):
    sim.crash(np.array([7]))
    drop = np.zeros(sim.config.capacity, dtype=np.float32)
    drop[[2, 30, 44]] = 1.0
    drop[[5, 11, 19, 50]] = (0.2, 0.5, 0.5, 0.9)
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


@pytest.mark.parametrize("probability", [0.0, 0.2, 0.5, 0.9, 1.0])
def test_fused_plain_matches_jax_at_each_drop_probability(probability):
    """Every live node but one lossy at one probability, so most edges'
    outcomes turn on the draw (at 0 none draws, at 1 none needs to)."""
    def lossy(sim):
        sim.crash(np.array([7]))
        return {"drop_prob": np.full(sim.config.capacity, probability, dtype=np.float32)}

    config, state, inputs = _jax_case({}, lossy, seed_counters=(0, 3))
    want = _assert_matches_jax(config, state, inputs, random_loss=True)
    quiet = _assert_matches_jax(config, state, inputs)
    moved = any(not np.array_equal(np.asarray(want[n]), np.asarray(quiet[n]))
                for n in ("fd_fail", "alerted"))
    assert moved == (probability > 0.0), "the loss should matter exactly when it is on"


@pytest.mark.parametrize("overrides", [{}, {"fd_gray_confirm": 3, "fd_threshold": 8},
                                       {"rounds_per_interval": 4}])
def test_fused_plain_matches_jax_random_loss_below_one(overrides):
    """Drop probabilities between 0 and 1: which probes drop depends on every
    bit of the draw, so this holds the threefry draw to JAX's as well."""
    config, state, inputs = _jax_case(overrides, _half_lossy, seed_counters=(0, 9))
    want = _assert_matches_jax(config, state, inputs, random_loss=True)
    plain = _assert_matches_jax(config, state, dataclasses.replace(
        inputs, drop_prob=inputs.drop_prob * (inputs.drop_prob >= 1.0)), random_loss=True)
    assert any(not np.array_equal(np.asarray(want[n]), np.asarray(plain[n]))
               for n in ("fd_fail", "fd_streak", "fd_ok")), "the partial loss should matter"


# --------------------------------------------------------------------- #
# Against a numpy reference, and the wrapper's CPU path
# --------------------------------------------------------------------- #


def _case(c, k, seed, device="cpu", random=True, joiners=True, round_=None):
    """State and fault plane of one round at [c, k], the adjacency from
    ``engine.device_initial_state`` over random ring orders, the state's key
    from ``seed``, counters and latches seeded from numpy, and with
    ``random`` drop probabilities 0, 0.25, 0.5 and 1 (else ``drop_prob``
    None: random loss off). Returns the wrapper's positional inputs."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    config = engine.SimConfig(capacity=c, k=k)
    active = torch.from_numpy(rng.random(c) < 0.95).to(dev)
    ranks = torch.from_numpy(
        np.stack([rng.permutation(c) for _ in range(k)]).astype(np.int32)).to(dev)
    state = engine.device_initial_state(
        config, ranks, active, active.clone(), torch.zeros(c, dtype=torch.int32, device=dev),
        torch.ones(c, dtype=torch.bool, device=dev), threefry.prng_key(seed, dev),
    )
    observers = state.observers
    if joiners:  # inactive rows hold expected observers, as after a join wave
        inactive = (~active).nonzero().flatten()
        observers = observers.clone()
        observers[inactive] = torch.from_numpy(
            rng.integers(0, c, (len(inactive), k)).astype(np.int32)).to(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    alive, drop_prob = rng.random(c) < 0.97, rng.choice([0.0, 0.25, 0.5, 1.0], c)
    return (
        active, t(alive), t(drop_prob.astype(np.float32)) if random else None,
        state.subjects, observers, t(rng.random((c, k)) < 0.05),
        t(rng.random((c, k)) < 0.02), state.rng_key,
        t(rng.integers(0, 256, (c, k)).astype(np.uint8)), t(rng.random((c, k)) < 0.1),
        t(rng.integers(0, 256, (c, k)).astype(np.uint8)),
        t(rng.integers(0, 256, (c, k)).astype(np.uint8)),
        torch.tensor(int(rng.integers(0, 100)) if round_ is None else round_,
                     dtype=torch.int32, device=dev),
    )


def _reference(args, threshold, gray_confirm, gray_warmup, rpi, draw=None):
    """The fused phase in numpy, its draw the round's whole ``[C, K]`` block
    from the key (``threefry.draw_plain``) unless ``draw`` is given."""
    if draw is None and args[2] is not None:
        draw = threefry.draw_plain(args[7].cpu(), *args[3].shape)[1].numpy()
    (active, alive, drop_prob, subjects, observers, probe_drop, down_reports, _,
     fd_fail, alerted, fd_streak, fd_ok, round_) = (
        None if a is None else a.cpu().numpy() for a in args)
    c, k = subjects.shape
    alive = alive & active
    phase = ((np.arange(c, dtype=np.uint64) * 2654435761) % 2**32) % rpi
    up = alive & (phase == int(round_) % rpi)
    watching = active[:, None] & active[subjects] & up[:, None]
    ok = alive[subjects] & ~probe_drop
    if drop_prob is not None:
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
    bad_key = list(args)
    bad_key[7] = args[7].to(torch.int32)
    with pytest.raises(TypeError, match="key"):
        kernels.fd_phase_fused(*bad_key, **kw)
    bad_key[7] = args[7][:1]
    with pytest.raises(ValueError, match="key"):
        kernels.fd_phase_fused(*bad_key, **kw)
    with pytest.raises(TypeError, match="halt"):
        kernels.fd_phase_fused(*args, **kw, halt=torch.tensor(1))


@pytest.mark.parametrize("halted", [False, True])
def test_fused_plain_splits_the_key_and_keeps_it_when_halted(halted):
    """The new key is the split's, or the key as it came in a halted round;
    the halt flag changes no other output (the caller masks the round)."""
    args = _case(200, 10, seed=4)
    kw = dict(threshold=10)
    got = kernels.fd_phase_fused(*args, **kw, halt=torch.tensor(halted))
    want = kernels.fd_phase_fused(*args, **kw)
    split_key, _ = threefry.split(args[7])
    assert torch.equal(want[8], split_key)
    assert torch.equal(got[8], args[7] if halted else split_key)
    for name, g, w in zip(OUTPUTS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_plain_draws_only_where_it_can_matter(seed):
    """The plain phase's loss (the compare against the round's whole
    ``[C, K]`` block) equals, edge by edge, the rule the FD kernels apply:
    an edge draws its own word, at its counter, only where its observer
    probes a live subject past probe_drop whose drop probability lies in
    (0, 1); at a probability of 1 or more the probe is lost without a draw,
    and no other edge's word can change an outcome (draws lie in [0, 1))."""
    args = list(_case(300, 10, seed=seed, joiners=False))
    c, k = args[3].shape
    rng = np.random.default_rng(seed)
    args[2] = torch.from_numpy(rng.choice([0.0, 0.1, 0.5, 0.9, 1.0, 1.5], c).astype(np.float32))
    kw = dict(threshold=10, rounds_per_interval=2)
    got = kernels.fd_phase_fused_plain(*args, **kw)
    _, probe = threefry.split(args[7])
    active, alive, prob, subj, probe_drop = (args[i].numpy() for i in (0, 1, 2, 3, 5))
    up = alive & active
    phase = ((np.arange(c, dtype=np.uint64) * 2654435761) % 2**32) % 2
    observer = up & (phase == int(args[12]) % 2)
    p = prob[subj]
    need = observer[:, None] & active[:, None] & up[subj] & ~probe_drop & (p > 0) & (p < 1)
    # an edge without a word of its own takes 0: lost where its probability
    # is positive, which decides an outcome only at a probability of 1 or
    # more (outside the need mask a loss changes nothing)
    draw = np.zeros((c, k), dtype=np.float32)
    for e in np.flatnonzero(need):
        draw.flat[e] = float(threefry.uniform(probe, (1,), offset=int(e))[0])
    want = _reference(tuple(args), 10, 0, 3, 2, draw=draw)
    for name, g, w in zip(OUTPUTS, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    lost = need & (draw < p)
    assert lost.any() and (need & ~lost).any(), "some draws should drop, some not"


def test_scan_round_goes_through_the_fused_wrapper(monkeypatch):
    """``engine.step`` hands the state's int32 adjacency, its round counter,
    its key and its decision flag to ``fd_phase_fused``, the drop
    probabilities only with random loss, and calls ``threefry_draw`` at
    no time: the FD kernel splits the key and draws."""
    calls = []
    real = kernels.fd_phase_fused

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(kernels, "fd_phase_fused", spy)
    monkeypatch.setattr(kernels, "threefry_draw", None)  # any call would raise
    from rapid_tpu_torch.sim.driver import Simulator

    config = engine.SimConfig(capacity=64, rounds_per_interval=2)
    state = Simulator(64, config=config, seed=1, device="cpu").state
    inputs = engine.const_inputs(config, np.ones(64, dtype=bool), device="cpu")
    engine.step(config, state, inputs, random_loss=True)
    engine.step(config, state, inputs, random_loss=False)
    assert len(calls) == 2
    (args, kw), (args2, _) = calls
    assert args[3] is state.subjects and args[4] is state.observers
    assert args[3].dtype == torch.int32 and args[12] is state.round
    assert args[7] is state.rng_key and args2[7] is state.rng_key
    assert args[2] is inputs.drop_prob and args2[2] is None
    assert kw["halt"] is state.decided
    assert kw["rounds_per_interval"] == 2 and kw["threshold"] == config.fd_threshold


@pytest.mark.parametrize("variant", sorted(fd_variants.VARIANTS))
def test_fd_variant_patches_apply_once_to_the_source(variant):
    """Each variant of ``sim.fd_variants`` (a design choice undone, timed on
    the card) patches ``csrc/fd_phase_fused.cu`` as it is written: every
    patch matches exactly one place, in turn, so the variant builds what it
    names."""
    text = (kernels._CSRC / "fd_phase_fused.cu").read_text()
    for old, new in fd_variants.VARIANTS[variant]:
        assert text.count(old) == 1, (variant, old)
        text = text.replace(old, new)


def test_fold_compare_needs_a_card(capsys):
    """``sim.fold_compare`` (the folded kernel timed beside the pair it
    replaced) asks for the parent's sources and exits 2 on the CPU before it
    builds anything."""
    from rapid_tpu_torch.sim import fold_compare

    with pytest.raises(SystemExit) as exc:
        fold_compare.main([])
    assert exc.value.code == 2
    assert fold_compare.main(["--parent", "missing"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #


def _assert_kernel_matches_plain(args, kw, counter="fd_phase_fused"):
    before = dict(kernels.LAUNCHES)
    got = kernels.fd_phase_fused(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**before, counter: before[counter] + 1}
    want = kernels.fd_phase_fused_plain(*args, **kw)
    assert len(got) == len(want) == 9
    for name, g, w in zip(OUTPUTS + ("fd_hist", "fd_seen", "key"), got, want):
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("halted", [False, True])
@pytest.mark.parametrize("gray, rpi, random", [
    (0, 1, True), (3, 4, True), (0, 4, False), (3, 1, False),
])
@pytest.mark.parametrize("c", [1, 333, 100_000, 1_000_000])
def test_cuda_fused_kernel_matches_plain(cuda_device, c, gray, rpi, random, halted):
    """Every output and the new key, at fractional drop probabilities,
    halted (the key kept) and not."""
    args = _case(c, 10, seed=c + gray + rpi, device=cuda_device, random=random)
    kw = dict(threshold=10, gray_confirm=gray, gray_warmup=3, rounds_per_interval=rpi,
              halt=torch.tensor(halted, device=cuda_device))
    got = _assert_kernel_matches_plain(args, kw)
    assert torch.equal(got[8], args[7]) == halted


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
    call over every shard (``per_device``) or one a shard, each shard's draw
    folded with its index, then ``fd_gather`` (``fd_bench.split_case``,
    ``fd_bench.run_split``): the kernels with ``kernel``, else the plain
    versions. Returns the fused phase's nine outputs (``alive`` as None)
    and the bitset."""
    calls, bits = fd_bench.split_case(args, kw, shards)
    return fd_bench.run_split(calls, bits, args, kernel, per_device, **extra), bits


def _certain(args):
    """A case's inputs with every fractional drop probability taken to 0, so
    that no draw decides an outcome: the shards' folds then change nothing,
    and the split can be held to the fused phase."""
    if args[2] is None:
        return args
    return tuple(args[:2]) + ((args[2] >= 1.0).float(),) + tuple(args[3:])


def _assert_equals_fused(got, args, kw):
    """The split's outputs (``_split_phase``) equal the fused phase's, the
    new key too."""
    want = kernels.fd_phase_fused_plain(*args, **kw)
    for name, g, w in zip(OUTPUTS + ("fd_hist", "fd_seen", "key"), got, want):
        if name == "alive":
            continue
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name


def _assert_split_equals_fused(args, kw, shards, kernel=False, per_device=True):
    """The split against the fused phase: under random loss at drop
    probabilities 0 and 1 only (``_certain``). Returns the split's outputs
    and bitset."""
    args = _certain(args)
    got, bits = _split_phase(args, kw, shards, kernel, per_device)
    _assert_equals_fused(got, args, kw)
    return got, bits


@pytest.mark.parametrize("per_device", [False, True])
@pytest.mark.parametrize("random", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("c, shards", SPLITS)
def test_split_plain_equals_fused_plain(c, shards, policy, random, per_device):
    """One plain call a shard, or one plain call over every shard: against
    the fused phase (under random loss where no draw decides), and the two
    forms against each other at the case's fractional drop probabilities."""
    args = _case(c, 10, seed=c + shards, random=random)
    kw = _policy_kw(policy, c, seed=c * shards, device="cpu")
    got, _ = _assert_split_equals_fused(args, kw, shards, per_device=per_device)
    assert (got[2] & ~args[9]).any(), "the case should raise alerts"
    got, bits = _split_phase(args, kw, shards, per_device=per_device)
    other, other_bits = _split_phase(args, kw, shards, per_device=not per_device)
    assert torch.equal(bits, other_bits)
    for g, w in zip(got, other):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("per_device", [False, True])
@pytest.mark.parametrize("policy", ["cumulative", "gray"])
@pytest.mark.parametrize("c, shards", SPLITS)
def test_split_plain_with_folds_equals_fused_reference(c, shards, policy, per_device):
    """Each shard drawing as the sharded JAX round does (the probe key
    folded with its index, over its local edges): the split equals the
    numpy reference of the fused phase given those shards' blocks stacked
    as the round's draw, and the key is the split's."""
    args = _case(c, 10, seed=c * 3 + shards)
    kw = _policy_kw(policy, c, seed=c * shards, device="cpu")
    got, _ = _split_phase(args, kw, shards, per_device=per_device)
    _, draw = threefry.draw_plain(args[7], c // shards, 10, list(range(shards)))
    want = _reference(args, kw["threshold"], kw.get("gray_confirm", 0), kw.get("gray_warmup", 3),
                      kw.get("rounds_per_interval", 1), draw=draw.numpy())
    for name, g, w in zip(OUTPUTS, got, want):
        if name != "alive":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert torch.equal(got[8], threefry.split(args[7])[0])
    unfolded = _reference(args, kw["threshold"], kw.get("gray_confirm", 0),
                          kw.get("gray_warmup", 3), kw.get("rounds_per_interval", 1))
    assert not all(np.array_equal(g.numpy(), w) for g, w in zip(got[1:5], unfolded[1:5])), (
        "the fold should change some outcome")


def _assert_halted(args, kw, shards, kernel=False, alerts=True):
    """A halted call over every shard: each plane as it came in, every
    segment (padding and flag included) zero and the key as it came; with
    ``alerts`` the same call not halted raises some. Returns the halted
    planes and bitset."""
    calls, bits = fd_bench.split_case(args, kw, shards)
    merged, merged_kw = fd_bench.device_call(calls)
    rows_fn = kernels.fd_phase_rows if kernel else kernels.fd_phase_rows_plain
    halt = torch.tensor(True, device=args[0].device)
    outs, key = rows_fn(*merged, **merged_kw, halt=halt)
    assert torch.equal(key, args[7])
    assert len(outs) == shards
    for (a, a_kw), out in zip(calls, outs):
        planes_in = (a[6], a[7], a[8], a[9], a_kw["fd_hist"], a_kw["fd_seen"])
        for name, i, o in zip(("fd_fail", "alerted", "fd_streak", "fd_ok", "fd_hist",
                               "fd_seen"), planes_in, out):
            assert (i is None and o is None) or (o.dtype == i.dtype and torch.equal(o, i)), name
    halted = bits.clone()
    assert not halted.any()
    _, key = rows_fn(*merged, **merged_kw, halt=~halt)
    assert torch.equal(key.cpu(), threefry.split(args[7].cpu())[0])
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
    row_args = (args[0], args[1], args[2], block[3], block[5], args[7], block[8], block[9],
                block[10], block[11], args[12])
    with pytest.raises(ValueError, match="outside"):
        kernels.fd_phase_rows(*row_args, bits[:words], row0=50, fold=0, threshold=10)
    with pytest.raises(ValueError, match="bits"):
        kernels.fd_phase_rows(*row_args, bits[:words - 1], row0=0, fold=0, threshold=10)
    with pytest.raises(TypeError):
        kernels.fd_phase_rows(*row_args, bits[:words].long(), row0=0, fold=0, threshold=10)
    with pytest.raises(ValueError, match="tile"):
        kernels.fd_gather(args[0], args[4], args[6], bits, 15)
    with pytest.raises(ValueError, match="bits"):
        kernels.fd_gather(args[0], args[4], args[6], bits[1:], 16)
    with pytest.raises(ValueError, match="shard index"):
        kernels.fd_phase_rows(*row_args, bits[:words], row0=0, fold=-1, threshold=10)
    with pytest.raises(TypeError, match="key"):
        kernels.fd_phase_rows(*row_args[:5], args[7].int(), *row_args[6:], bits[:words],
                              row0=0, fold=0, threshold=10)


def test_per_device_wrapper_checks_its_shards():
    """A call over several shards: one value a shard in every per-shard
    argument, every shard's global index given, at most
    MAX_SHARDS_PER_CALL, no empty shard, and a 0-d bool halt."""
    args = _case(64, 10, seed=9)
    calls, _ = fd_bench.split_case(args, dict(threshold=10), 4)
    merged, kw = fd_bench.device_call(calls)
    kernels.fd_phase_rows(*merged, **kw)
    short = list(merged)
    short[3] = merged[3][:3]  # three subjects blocks for four shards
    with pytest.raises(ValueError, match="subjects"):
        kernels.fd_phase_rows(*short, **kw)
    with pytest.raises(ValueError, match="shard index"):  # one shard without its index
        kernels.fd_phase_rows(*merged, **dict(kw, fold=[None, 1, 2, 3]))
    with pytest.raises(ValueError, match="fold"):
        kernels.fd_phase_rows(*merged, **dict(kw, fold=[0, 1, 2]))
    with pytest.raises(TypeError):
        kernels.fd_phase_rows(*merged, **kw, halt=torch.tensor(1))
    with pytest.raises(ValueError, match="halt"):
        kernels.fd_phase_rows(*merged, **kw, halt=torch.tensor([True]))
    many = fd_bench.split_case(args, dict(threshold=10), 32)[0]
    merged, kw = fd_bench.device_call(many[:kernels.MAX_SHARDS_PER_CALL + 1])
    with pytest.raises(ValueError, match="at most"):
        kernels.fd_phase_rows(*merged, **kw)
    empty = list(fd_bench.device_call(calls[:1])[0])
    for i in (3, 4, 6, 7, 8, 9):
        empty[i] = [empty[i][0][:0]]
    empty[11] = [torch.zeros(1, dtype=torch.int32)]
    with pytest.raises(ValueError, match="empty"):
        kernels.fd_phase_rows(*empty, row0=[0], fold=[0], threshold=10)


CUDA_SPLITS = [(1, 1), (333, 3), (333, 9), (1000, 8), (100_000, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("halted", [False, True])
@pytest.mark.parametrize("random", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("c, shards", CUDA_SPLITS)
def test_cuda_split_kernels_match_plain(cuda_device, c, shards, policy, random, halted):
    """The per-device fd_phase_rows over every shard and the gather against
    their plain versions (the whole bitset included, flag and padding, and
    the new key), at fractional drop probabilities, each shard's draw folded
    with its index as on a mesh; without random loss, the split against the
    fused phase; halted, every plane as it came in, no bit and the key kept.
    One launch a call."""
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
        want, key = kernels.fd_phase_rows_plain(*merged, **merged_kw,
                                                halt=torch.tensor(True, device=cuda_device))
        assert torch.equal(bits, want_bits) and torch.equal(key, args[7])
        for g_shard, w_shard in zip(got, want):
            for g, w in zip(g_shard, w_shard):
                assert (g is None and w is None) or torch.equal(g, w)
        return
    got, bits = _split_phase(args, kw, shards, kernel=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**before, counter: before[counter] + 1,
                                "fd_gather": before["fd_gather"] + 1}
    want, want_bits = _split_phase(args, kw, shards)
    assert torch.equal(bits, want_bits)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    if not random:
        _assert_equals_fused(got, args, kw)


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
    scalar path, in a call over all three shards and in one call a shard,
    each shard's draw folded with its index; the segments, the planes and
    the key still match the plain version."""
    args = _case(333, 10, seed=offset, device=cuda_device)
    kw = dict(threshold=10, gray_confirm=3, gray_warmup=3, rounds_per_interval=1)
    rows, words = 111, kernels.segment_words(111, 10)
    blocks = [[None if a is None or a.dim() != 2 else
               _misaligned(a[s * rows:(s + 1) * rows], offset) for a in args] for s in range(3)]
    per_shard = [(b[3], b[5], b[8], b[9], b[10], b[11]) for b in blocks]
    cols = [list(col) for col in zip(*per_shard)]
    merged = (args[0], args[1], args[2], cols[0], cols[1], args[7], *cols[2:], args[12])
    got_bits = torch.full((3 * words,), -1, dtype=torch.int32, device=cuda_device)
    want_bits = torch.zeros(3 * words, dtype=torch.int32, device=cuda_device)
    segments = [list(bits.split(words)) for bits in (got_bits, want_bits)]
    folds = [0, 1, 2]
    got, got_key = kernels.fd_phase_rows(*merged, segments[0], row0=[0, rows, 2 * rows],
                                         fold=folds, **kw)
    want, want_key = kernels.fd_phase_rows_plain(*merged, segments[1],
                                                 row0=[0, rows, 2 * rows], fold=folds, **kw)
    assert torch.equal(got_key, want_key)
    for s in range(3):
        one_bits = torch.full((words,), -1, dtype=torch.int32, device=cuda_device)
        b = per_shard[s]
        one, one_key = kernels.fd_phase_rows(args[0], args[1], args[2], b[0], b[1], args[7],
                                             *b[2:], args[12], one_bits, row0=s * rows,
                                             fold=s, **kw)
        torch.cuda.synchronize()
        assert torch.equal(one_bits, want_bits[s * words:(s + 1) * words])
        assert torch.equal(one_key, want_key)
        for g, o, w in zip(got[s], one, want[s]):
            assert (g is None and w is None) or (torch.equal(g, w) and torch.equal(o, w))
    assert torch.equal(got_bits, want_bits)
