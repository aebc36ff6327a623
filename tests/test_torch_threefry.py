"""The port's random-loss draw (``rapid_tpu_torch/sim/threefry.py``, the plain
version of the bits the FD kernels make edge by edge and the CUDA kernel
``kernels.threefry_draw`` makes as a block) against ``jax.random`` on the
CPU: ``PRNGKey``, ``split``, ``fold_in`` and ``uniform``, bit for bit,
at seeds 0, 3, 7, 42 and 2**31 - 1 and shapes (1, 1), (37, 10) and
(1000, 10); the counter's high word against JAX's threefry primitive; the
wrapper's CPU path; ``tests/golden/torch_threefry.json`` (which
``chip_smoke.py`` holds the kernel to on the card), against the port and
against JAX today, so the file cannot go stale unseen; and lossy decisions
of both simulators, equal round for round.

Tolerance: exact, every bit of every word. The port implements JAX's
``jax_threefry_partitionable`` mode with 32-bit integers, which is how the
JAX package runs; a JAX that changed either would fail here, by name.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

import chip_smoke
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu_torch.sim import kernels, threefry
from rapid_tpu_torch.sim.driver import Simulator

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden"))

import generate_torch_threefry  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

SEEDS = [0, 3, 7, 42, 2**31 - 1]
SHAPES = [(1, 1), (37, 10), (1000, 10)]

with open(chip_smoke.THREEFRY_GOLDEN) as _f:
    GOLDEN = json.load(_f)


def _words(x):
    """The uint32 words of a key or of float32 bits, as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x.astype(np.uint32)


def test_jax_runs_the_mode_the_port_implements():
    assert jax.config.jax_threefry_partitionable, (
        "the port implements threefry's partitionable mode (JAX 0.9's default); this JAX "
        "draws otherwise")
    assert not jax.config.jax_enable_x64, "the port's PRNGKey takes 32-bit seeds, as JAX does"
    assert tuple(chip_smoke.THREEFRY_SEEDS) == tuple(SEEDS)
    assert tuple(chip_smoke.THREEFRY_SHAPES) == tuple(SHAPES)


@pytest.mark.parametrize("seed", SEEDS + [2**32 + 5])
def test_prng_key_split_and_fold_in_match_jax(seed):
    key, jkey = threefry.prng_key(seed), jax.random.PRNGKey(seed)
    assert key.dtype == torch.int64 and key.shape == (2,)
    np.testing.assert_array_equal(_words(key), np.asarray(jkey))
    new, probe = threefry.split(key)
    jnew, jprobe = jax.random.split(jkey)
    np.testing.assert_array_equal(_words(new), np.asarray(jnew))
    np.testing.assert_array_equal(_words(probe), np.asarray(jprobe))
    for data in (0, 3, 7, 2**31 - 1):
        np.testing.assert_array_equal(_words(threefry.fold_in(probe, data)),
                                      np.asarray(jax.random.fold_in(jprobe, data)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax_bit_for_bit(seed, shape):
    _, probe = threefry.split(threefry.prng_key(seed))
    _, jprobe = jax.random.split(jax.random.PRNGKey(seed))
    got, want = threefry.uniform(probe, shape), jax.random.uniform(jprobe, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_words(got), _words(want))
    folded = threefry.uniform(threefry.fold_in(probe, 5), shape)
    np.testing.assert_array_equal(
        _words(folded), _words(jax.random.uniform(jax.random.fold_in(jprobe, 5), shape)))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("offset", [2**32 - 3, 2**32, 3 * 2**32 + 17, 2**40 + 2**33 - 1])
def test_high_counter_word_matches_jax_threefry(offset):
    """Counters past 2**32 (a draw of more than 2**32 elements, which no
    shape here reaches) through the plain function's counter offset,
    against JAX's threefry primitive on the same counter pairs."""
    key = threefry.prng_key(7)
    counters = np.arange(offset, offset + 6, dtype=np.uint64)
    hi, lo = (counters >> 32).astype(np.uint32), (counters & 0xFFFFFFFF).astype(np.uint32)
    b1, b2 = jax_prng.threefry2x32_p.bind(jnp.uint32(0), jnp.uint32(7), jnp.asarray(hi),
                                         jnp.asarray(lo))
    want = np.asarray(b1) ^ np.asarray(b2)
    np.testing.assert_array_equal(_words(threefry.random_bits(key, (6,), offset)), want)
    floats = ((want >> 9) | 0x3F800000).view(np.float32) - np.float32(1.0)
    np.testing.assert_array_equal(_words(threefry.uniform(key, (2, 3), offset)),
                                  _words(floats.reshape(2, 3)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_at_scattered_counters_is_the_block_s(seed):
    """One word at a flat counter (``uniform`` of one element at that
    offset, what the FD kernels compute for one edge) at scattered counters
    equals those elements of ``uniform``'s block and of JAX's ``uniform``,
    bit for bit."""
    _, probe = threefry.split(threefry.prng_key(seed))
    _, jprobe = jax.random.split(jax.random.PRNGKey(seed))
    counters = np.random.default_rng(seed).choice(1000 * 10, 300, replace=False)
    got = torch.cat([threefry.uniform(probe, (1,), int(e)) for e in counters])
    block = threefry.uniform(probe, (1000, 10)).reshape(-1)
    want = np.asarray(jax.random.uniform(jprobe, (1000, 10))).reshape(-1)
    np.testing.assert_array_equal(_words(got), _words(block[counters]))
    np.testing.assert_array_equal(_words(got), _words(want[counters]))


@pytest.mark.parametrize("halted", [None, False, True])
def test_round_keys_split_or_keep_as_jax_s_round(halted):
    """A round's keys: JAX's split, the new key kept as it came where the
    halt flag holds (the JAX engine's masked round), the probe key the
    split's either way."""
    key = threefry.prng_key(17)
    halt = None if halted is None else torch.tensor(halted)
    new, probe = threefry.round_keys(key, halt)
    jnew, jprobe = jax.random.split(jax.random.PRNGKey(17))
    np.testing.assert_array_equal(_words(new), np.asarray(key if halted else jnew))
    np.testing.assert_array_equal(_words(probe), np.asarray(jprobe))


@pytest.mark.parametrize("rows, k, shards", [(37, 10, None), (0, 10, None), (12, 10, [3]),
                                             (8, 4, [0, 1, 2, 3, 4, 5, 6, 7]), (5, 3, [6, 2])])
def test_wrapper_cpu_path_is_the_plain_draw_and_jax_s(rows, k, shards):
    """On a CPU key ``kernels.threefry_draw`` takes the plain version and
    counts no launch; the draw is JAX's sharded round's: the probe key folded
    with each shard's index, the blocks stacked in the order given."""
    key = threefry.prng_key(11)
    before = dict(kernels.LAUNCHES)
    got_key, got = kernels.threefry_draw(key, rows, k, shards)
    assert kernels.LAUNCHES == before
    want_key, want = generate_torch_threefry.jax_draw(11, rows, k, shards)
    np.testing.assert_array_equal(_words(got_key), want_key)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_words(got), _words(want))


@pytest.mark.parametrize("rows, shards", [(37, None), (0, None), (12, [3, 5])])
@pytest.mark.parametrize("halted", [False, True])
def test_wrapper_halt_flag_keeps_the_key_and_not_the_draw(halted, rows, shards):
    """With the halt flag set the new key is the key as it came (JAX's
    masked round keeps it), clear it is the split's; the draw is the split's
    probe draw either way."""
    key = threefry.prng_key(11)
    split_key, want = kernels.threefry_draw(key, rows, 10, shards)
    got_key, got = kernels.threefry_draw(key, rows, 10, shards, halt=torch.tensor(halted))
    assert torch.equal(got_key, key if halted else split_key)
    np.testing.assert_array_equal(_words(got), _words(want))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    key = threefry.prng_key(1)
    with pytest.raises(TypeError, match="int64"):
        kernels.threefry_draw(key.to(torch.int32), 4, 10)
    with pytest.raises(TypeError, match="int64"):
        kernels.threefry_draw(torch.zeros(3, dtype=torch.int64), 4, 10)
    with pytest.raises(ValueError, match="shards"):
        kernels.threefry_draw(key, 4, 10, list(range(kernels.MAX_SHARDS_PER_CALL + 1)))
    with pytest.raises(ValueError, match="shard indices"):
        kernels.threefry_draw(key, 4, 10, [-1])
    with pytest.raises(ValueError, match="out of range"):
        kernels.threefry_draw(key, 4, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.threefry_draw(key.to("meta"), 4, 10)
    with pytest.raises(TypeError, match="halt"):
        kernels.threefry_draw(key, 4, 10, halt=torch.tensor(1))
    with pytest.raises(ValueError, match="halt"):
        kernels.threefry_draw(key, 4, 10, halt=torch.tensor([True]))


# --------------------------------------------------------------------- #
# The golden file
# --------------------------------------------------------------------- #


def _port_vectors(cases):
    return [chip_smoke.threefry_vector(*(t.numpy() for t in kernels.threefry_draw(
        threefry.prng_key(seed), rows, k, shards))) for seed, rows, k, shards in cases]


def test_golden_cases_are_the_smoke_s():
    cases = chip_smoke.threefry_cases()
    assert len(GOLDEN["vectors"]) == len(cases)
    for vector, (_, rows, k, shards) in zip(GOLDEN["vectors"], cases):
        assert vector["shape"] == [rows * (len(shards) if shards else 1), k]
        assert ("words" in vector) == (rows * k * (len(shards) if shards else 1)
                                       <= chip_smoke.THREEFRY_WORDS)


def test_port_equals_the_golden_vectors():
    """Every vector of the seeds and shapes, and the 8-shard main-path
    draw; the 1M draw is held on the card, where it is fast."""
    cases = chip_smoke.threefry_cases()
    keep = [i for i, (_, rows, _, _) in enumerate(cases) if rows < 1_000_000]
    got = _port_vectors([cases[i] for i in keep])
    assert chip_smoke._golden_misses(got, [GOLDEN["vectors"][i] for i in keep]) == []


def test_jax_still_equals_the_golden_vectors():
    assert chip_smoke._golden_misses(generate_torch_threefry.jax_vectors(),
                                     GOLDEN["vectors"]) == []


def test_golden_lossy_decision_port_and_jax():
    """The file's lossy decision (10 000 members, 1% at ingress loss 0.5):
    the port on the CPU and the JAX package today give the file's record."""
    want = GOLDEN["decision"]
    assert len(want["cut"]) == chip_smoke.THREEFRY_DECISION["members"]
    assert chip_smoke.threefry_decision(Simulator, device="cpu") == want
    assert generate_torch_threefry.jax_decision() == want


# --------------------------------------------------------------------- #
# Lossy decisions, round for round
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("probability", [0.5, 0.8])
def test_lossy_decision_matches_jax_virtual_time(probability):
    """200 members, seed 3, victims 11, 40 and 77 at ingress loss p: the
    draws decide when each victim's edges fail, so the decision's virtual
    time is the draw's; the port's equals JAX's (a generator other than
    threefry gave 23 100 ms against JAX's 27 100 ms at p 0.5)."""
    records, sims = [], []
    for sim in (JaxSimulator(200, seed=3), Simulator(200, seed=3, device="cpu")):
        sim.ingress_loss(np.array([11, 40, 77]), probability)
        rec = sim.run_until_decision(64, 16)
        assert rec is not None
        records.append((sorted(int(c) for c in rec.cut), int(rec.configuration_id),
                        int(rec.virtual_time_ms), sim.metrics.get("rounds")))
        sims.append(sim)
    assert records[1] == records[0]
    assert records[1][0] == [11, 40, 77]
    np.testing.assert_array_equal(_words(sims[1].state.rng_key), np.asarray(sims[0].state.rng_key))
