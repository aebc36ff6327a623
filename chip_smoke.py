"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU, and hold
every kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU (sm_90a:
H100/H200) and the CUDA toolkit. The first run builds the kernels with nvcc
into build/kernels/. Phases, each of which must pass:

1. the card, the torch and CUDA versions, and the kernel build time;
2. each CUDA kernel against its plain version at [100_000, 10] and
   [1_000_000, 10], bit for bit, with CUDA-event timings of both; the fused
   FD phase (``fd_phase_fused``, which splits the state's key and draws each
   lossy edge's threefry word itself) with the gray path off and on and with
   1 and 4 rounds per interval, at fractional drop probabilities, halted
   (the key kept) and not, timed cold (inputs rotated through more than the
   50 MB L2) and hot, in a round with alerts and in a quiet one, beside the
   unfused sequence it replaces (the draw, plain ops, ``fd_phase_u8``, the
   gather);
3. the headline: a 100k-member simulator, 1% of members crashed, one
   ``run_until_decision(16, 16)`` to warm, then the same timed on
   ``TIMED_RUNS`` fresh simulators (the closed-form branch); each cut must
   equal the crashed set;
4. the scan path: fresh 100k simulators under ingress loss 1.0 on 1% of
   members, which must decide that set through ``fd_phase_fused`` (and
   launch ``fd_phase_u8`` no time), at no more host syncs than before;
5. the windowed FD policy's kernel: ``fd_phase_fused`` windowed against its
   plain version, bit for bit, at [100_000, 10] and [1_000_000, 10], for
   W in {10, 16}, threshold fractions 0.4 and 0.7, 1 and 4 rounds per
   interval, random loss on and off, from partly filled windows; the
   windowed scan's variant timed cold and hot, in a round with alerts and in
   a quiet one;
6. windowed decisions at full width: 100k members, ``fd_policy="windowed"``,
   1% crashed (closed form) or under ingress loss 1.0 (the scan, which must
   launch the windowed kernel every round it executes), each deciding that
   set at 11 100 ms virtual;
7. the classic fallback at full width: 100k members in two delivery groups,
   a blind group of 26 000 that hears no broadcast (more than F = 24 999),
   1000 members of the other group crashed; the fast round stalls and
   ``run_until_decision(64, 16, classic_fallback_after_rounds=8)`` must
   decide the crashed set through the classic round, with the record the
   JAX package gives for it (``CLASSIC_RECORD``);
8. the port on the card against the port on the CPU at 1000 members, every
   state field and record: both branches under both FD policies, the
   classic fallback, and bridged extern votes;
9. the multi-device round loop (``rapid_tpu_torch/shard/engine.py``), every
   shard on this one card: one ``fd_phase_rows`` call over every shard's
   rows, the exchange into one bitset and ``fd_gather``, against
   ``fd_phase_fused_plain`` over the whole array and each kernel against its
   plain version, bit for bit, at [100_000, 10] over 4 and 8 shards and
   [1_000_000, 10] over 8, under the cumulative, gray and windowed policies,
   random loss on and off, each shard's draw folded with its index as on a
   mesh, and halted; the split timed cold beside
   ``fd_phase_fused``: the per-device call, one shard alone and one call a
   shard; then the headline fault through ``Simulator(mesh=...)`` on meshes
   of 4 and 8 shards and a (2, 2) ("dcn", "ici") mesh, each deciding the
   crashed set at 11 100 ms virtual with the single-device configuration
   id, one sync per dispatch and one ``fd_phase_rows`` and one
   ``fd_gather`` launch a round, beside the single-device closed form and
   scan path of the same fault, and the same members under ingress loss 1.0
   on 8 shards (the same launches, none of ``threefry_draw``);
10. telemetry, speculation, profiling: the headline decision and a crash
   under ingress loss 1.0 (the scan) with ``speculate`` on and off in
   alternating pairs (asked for explicitly: the default leaves it off on
   the card; identical records, speculation hits only when on, one sync
   either way), walls and the host view change beside each other; the
   speculation worker alone, and a decision of each branch with metrics,
   tracer, speculation and profiling on, inside ``jitwatch.timed_window``
   (sync debug mode "error": they must raise and record nothing, and both
   speculation hits must land) and every sync counted in the same decision
   audited by ``jitwatch``; ``enable_profiling`` on the
   scan path sampling every dispatch under both FD policies (the phases
   timed as device work, CUDA graph replays of the prefixes, beside the
   same state's host walls; the kernel counted once a replay; the captured
   step equal to the eager one; every phase of the best-of-5 sample and of
   at least 50 one-shot in-loop samples above 0; decisions with profiling
   on equal to those with it off under ingress loss 0.5 and 1.0); the GPU
   ops of one step and of its prefixes;
   and ``observability.device_trace`` around one decision, whose Chrome
   trace must name ``fd_phase_fused``;
11. the simulator bridge (``rapid_tpu_torch/sim/bridge.py``), run first after
   the build: ``TpuSimMessaging`` at 100k virtual members on the port's
   default protocol, ``warm_compile`` timed, and a scripted real member
   (``ScriptedMember`` over ``ScriptNetwork``, both defined here) that joins
   (one full configuration of 100 001 endpoints), votes in a crash of 1% in
   the closed form (that pump inside a ``jitwatch`` timed window) and in one
   under ingress loss 1.0 (the scan, launching ``fd_phase_fused``), leaves,
   and joins and votes in the crash again on a mesh of 4 shards on the card
   (``fd_phase_rows`` and ``fd_gather``); each decision's configuration id
   equal to a plain simulator's driven alike, each pump's wall split into
   dispatch, bridge host work and delivery, with its syncs by label and its
   kernel launches (``bridge_sequence``);
12. the wire: the port's codec (``rapid_tpu_torch/messaging/codec.py`` on
   its pure-Python MessagePack subset, no C library in the process) gives
   every frame of ``tests/golden/torch_wire_frames.json``, which
   ``rapid_tpu``'s codec wrote, byte for byte and decodes each back to an
   equal message; each frame class's encode and decode time, and a
   100k-member ``JoinResponse``'s and a 75 001-sender vote batch's
   (``wire_phase``);
13. the socket gateway (``rapid_tpu_torch/messaging/gateway.py``), after the
   bridge phase: ``SwarmGateway`` at 100k virtual members on the card,
   ``warm()`` timed, and a real member in a child OS process
   (``chip_smoke.py --gateway-member``, the ``ScriptedMember`` on the port's
   TCP transport, routed client and swarm broadcaster) that joins over TCP
   (one full configuration of 100 001 endpoints), votes in a crash of 1% run
   on the gateway's protocol thread (the closed form) and in one under
   ingress loss 1.0 (the scan, launching ``fd_phase_fused``), and leaves;
   every configuration id equal on the gateway, in the member's own view and
   on a plain simulator driven alike, and every sync of the protocol thread
   accounted for by a ``jitwatch`` label (``gateway_sequence``);
14. the driver's host planes, last: ``Simulator(100_000)`` with placement
   (8192 x 3), handoff, serving, the SLO plane, durability and an 8-cell
   hierarchy, driven with the bench's serving traffic through a crash of
   1% and a slot restart, every plane's invariant held and the decision's
   syncs equal to its labelled ones (``planes_path``); the placement kernel
   ``placement_topr`` against its plain version, bit for bit, at
   [8192, 100_000] (R 3, one virtual instance, 1% inactive), at
   [1024, 100_000] with weights 1-8, in an added-column merge of 1000
   columns into 8192 prior rows and at the planes path's own view change
   (its ~233 affected rows), timed cold and hot beside its bound, the plain
   version and, where a git archive of the parent commit is unpacked under
   build/parent, that commit's kernel in turns; every instantiation's
   registers and spills from ``nvcc -Xptxas -v``, built beside the kernels
   and none spilling (``topr_phase``); and the bench's serving dimension,
   the sweep's
   10 000-member placement point and hierarchy-zone-churn, each equal to
   what the JAX package gave (``tests/golden/torch_planes.json``,
   ``planes_golden_check``);
15. the mesh over several processes (after the single-controller meshes of
   9): ``python -m rapid_tpu_torch.cli.multihost_sim`` in 2 child processes
   of 2 shards each on this card (gloo over localhost), the 100k ingress
   loss 1.0, and in 4 processes of 1 shard the crash, every child
   under a wall timeout; every rank's record (cut, protocol time,
   configuration id) equal to an in-process single-controller mesh of the
   same shape and seed, 16 ``fd_phase_rows``, 16 ``fd_gather`` and no
   ``threefry_draw`` launches, 16 all-gathers and 16 ``shard.exchange`` syncs in each rank
   (``multihost_phase``);
16. the port's own fault plane (``rapid_tpu_torch/faults.py``): the bench's
   gray-detection dimension through ``replay_on_simulator``, equal to
   ``tests/golden/torch_gray.json``, which the JAX package wrote; then a
   plan at 100k (1% victims, half ``slow_node``, half a drop rule at
   probability 1.0, the gray streak on) replayed to a cut equal to the
   victims through ``fd_phase_fused``, the replay's host parts
   (``endpoint_slots``, ``apply_plan_at``) timed apart
   (``fault_replay_phase``);
17. real port members (after the gateway phase): ``member_sequence``, the
   port's own ``Cluster`` (``ClusterBuilder`` on the port's in-process
   transport, default ``Settings``, ``SwarmBroadcaster``) on
   ``TpuSimMessaging`` at 100k on the port's ``InProcessNetwork``, through
   ``bridge_sequence``'s script (join, the 1% crash in the closed form, the
   1% crash under ingress loss 1.0 through ``fd_phase_fused``, leave), then
   2 members joining in one pump and both voting in the crash; every
   member's configuration id and member list equal to the swarm's, each id
   to a plain simulator's; each pump's wall split into dispatch, the
   members' own host work (their join's view and service build apart) and
   the bridge's host work and delivery, beside the scripted member's pump;
   and ``agent_sequence``, ``python -m rapid_tpu_torch.cli.agent`` in a
   child process joining the port's ``SwarmGateway`` at 100k over TCP,
   through both crashes and a leave on SIGINT, its configuration id read
   through its status RPC after each step and equal to the gateway's and a
   plain simulator's (a mismatch fails the run with ``_agent_fork_dump``:
   both ids, the agent's journal and VIEW_CHANGE lines, the bridge's repair
   paths), each step's wall beside the scripted member's;
18. the protocol plane's live engines, after the agent (``live_planes_phase``,
   host Python, no kernel): 64 port members (``ClusterBuilder`` on the
   port's ``InProcessNetwork`` and ``VirtualScheduler``), placement 256 x 3,
   each on its own ``DurablePartitionStore`` with handoff and serving, the
   bench's serving traffic (``OpenLoopGenerator``) steady, through the crash
   of the member leading the hottest key's partition and after the view;
   the victim restarts from its WAL and rejoins; every acked write reads
   back, every handoff session completes, the replicas, configuration ids
   and placement versions agree; then 64 members in 8 hierarchy cells
   through a crash of one cell's leader (every leader's global fingerprint
   equal to a recompute), and the bench's recovery points on the port's
   store (replayed counts exact, content equal); all of it equal to
   ``tests/golden/torch_live_planes.json``, which the JAX package wrote;
19. the nemesis search and the forensics timeline, after the live planes
   (``search_phase``, host Python but for the sim harness's simulators on the
   card): the engine hunt at ``rapid_tpu_torch.cli.hunt``'s defaults (seed 0,
   200 probes); the flagged bug (``RAPID_BUG_NEWROW_SYNC=1``, seed 12, 120
   probes) found, shrunk to at most 3 rules and pinned, and the corpus pin
   green without the flag and violating with it; the sim-harness hunt (seed
   0, 20 probes, capacity 5); one sim probe at 100 000 members (the gray
   streak, a restart and an ingress drop at 1.0, so ``fd_phase_fused`` and
   ``placement_topr`` launch); the timeline over the bug's witness bundle,
   a skewed-churn cluster bundle of port members and the stuck-handoff
   fixtures, with the forensics CLI's exit codes; all of it equal to
   ``tests/golden/torch_search.json``, which the JAX package wrote, exactly,
   the sim probes whose plans draw loss below 1.0 included;
20. the native host plane (``rapid_tpu_torch/native.py``,
   ``runtime/native_io.py``, ``messaging/native_tcp.py``, the gateway's
   ``native_server``, ``profiling/scrape.py``; host C++, no kernel): (a)
   right after the kernel build, both libraries built with g++ from
   ``rapid_tpu_torch/csrc/host/`` and loaded, or the run fails; (b) on the
   bench headline's ``VirtualCluster.synthesize(100_000, 10, 42)``,
   ``synthesize``, ``ring_hashes``, ``xxh64_batch`` and ``config_fold``
   equal to the numpy paths, each wall both ways, and at 1 000 000 the
   native path timed and held to numpy on a seeded sample of 10 000 rows
   (``native_hashes``); after the agent phase, (c) the member phase's join
   (native: ``native.CALLS["ring_hashes"]`` must grow) and the same join
   with the native entry points patched to None here, each build split
   into ``_bulk_insert``, the identifier insort, the scalar configuration id
   and the service, one id (``native_member_join``); then the view build of
   those 100 000 endpoints alone, once on each path
   (``native_view_builds``); (d) ``agent_sequence`` with the agent on
   ``--transport native-tcp`` behind a gateway on the reactor
   (``native_gateway``; its ``gateway_sequence`` with the scripted member
   behind the reactor, every id equal to the Python server's run, runs in
   the CPU tests, and is cut here for time); (e) 3 port members on ``NativeTcpClientServer``
   scraped with ``ClusterStatusRequest(include_history=8)`` and folded with
   ``cluster_timeseries``, one series map a member holding its own counters
   (``native_scrape``);
21. the gRPC transport (``rapid_tpu_torch/messaging/http2.py`` under
   ``grpc_transport.GrpcServer`` / ``GrpcClient``; host Python, no kernel),
   after the native plane's (c)-(e) (``grpc_phase``): (a) the port's frame
   reader and HPACK decoder replay ``tests/golden/torch_grpc_frames.json``
   (grpcio's frames, captured where grpcio is installed) exactly; (b) the
   100k ``JoinResponse`` over one RPC between a port server and client on
   127.0.0.1, its wall split into encode, transfer and decode with its DATA
   frames, WINDOW_UPDATEs and flow-control stalls, beside the same reply
   over ``TcpClientServer`` and ``NativeTcpClientServer``, one call each,
   every reply equal; (c) a seed and 20 concurrent joiners on gRPC agreeing
   on one configuration id, then one crashed and the 20 left agreeing; (d)
   ``python -m rapid_tpu_torch.cli.agent --transport grpc`` joining a port
   seed and exiting 0 on SIGINT;
22. the scenario battery and the paper's experiments, after the planes
   (``scenarios_phase``): every ``BATTERY`` scenario of
   ``rapid_tpu_torch.cli.scenarios`` (the pinned corpus plans included) and
   flip-flop-join-1m, the most demanding of the 1M trio, at the registry's
   sizes through ``run_scenario`` on the card, each printed with its record, its kernel
   launches by name and its host split (builds, decisions, view changes,
   probe-drop masks, ``recomputed_config_id``), every check the record
   carries held (``scenario_misses``); hierarchy-zone-churn is 14's golden
   run, reported through ``zone_churn_run(result=...)``, not run twice;
   ``placement_topr`` launched in serving-sawtooth and overload-recover;
   crash-1k and one-way-loss at 1000 equal to the port's CPU path in every
   field but ``wall_s``; ``join_wave`` at 100k with a 1% wave,
   ``message_load`` at its defaults (in its own process, started before
   18), and ``fig11_conflict_sweep``'s skew-9 row equal to BASELINE.md's
   table;
23. the tools and examples, after the battery (``tools_examples_phase``):
   (a) ``rapid_tpu_torch.examples.load_balancer`` at the paper's Fig. 13
   shape (50 backends behind the port's ``SwarmGateway``, its simulator on
   the card, 10 failing at once, seed 23): one view change, the cut exactly
   the 10 victims, no route to a dead backend, the router's configuration
   id equal to the swarm's, with the keys moved out of 200, the wall and
   the launches of ``fd_phase_fused`` and ``placement_topr`` in the run
   (and, apart, in the gateway's warm-up before it);
   (b) ``examples.swarm_agent`` at 1000 virtual nodes with a 1% crash: the
   real member's id equal to the swarm's after the join and the crash, the
   swarm back to 990 after the leave; (c) ``cli.perfscope render`` over the
   port profiler's ``json_snapshot`` of a profiled 100k decision on the
   card (rc 0, four phase bars) and ``cli.tracecat`` over two port members'
   Chrome traces of one churn episode (rc 0, one shared ``virtual-time
   (ms)`` process);
24. the scaling sweep, last (``scaling_sweep_phase``):
   ``rapid_tpu_torch.experiments.scaling_sweep.run_size`` at 1k, 10k, 100k
   and 1M (seed 42), each size's JSON line with the cut held, its build
   seconds, and no kernel built or loaded and no ``fd_phase_fused`` launched
   in the timed window (the closed form); and the placement-and-handoff
   point at 100k through the same ``warmed_run`` (``sweep_point_run``);
25. the random-loss draw (``threefry_phase``, after the kernels of 2 and 5):
   the kernel ``threefry_draw`` (``csrc/threefry.cu``, JAX's threefry key
   split and uniform block, the bits of ``csrc/threefry.cuh``) against its
   plain version, bit for bit, at [100_000, 10] and [1_000_000, 10] and over
   the 8 shards of a 100k mesh with the fold, with its halt flag clear and
   set, and against ``tests/golden/torch_threefry.json``, which the JAX
   package wrote (every vector and digest); the file's lossy decision
   (10 000 members, 1% at ingress loss 0.5) run on the card, equal to the
   JAX package's record, with 48 ``fd_phase_fused`` launches and none of
   ``threefry_draw``; the kernel timed cold (after a write that evicts the
   L2) and hot at [100_000, 10] beside its plain version, ``torch.rand`` of the same shape
   and its bound, and the scan decisions' walls of 4. No round path
   launches ``threefry_draw``: the FD kernels split the key and make each
   lossy edge's word where they read it (on a mesh each device's
   ``fd_phase_rows`` call, with loss or without), and the expected launch
   counts say so.

Prints a JSON line of kernel results, one line of each phase's seconds, the
card's name and power limit, and as the last line ``{"ok": true, "device":
{...}}``. Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result. ``python3 chip_smoke.py --agent-loop N [M]`` runs 17's
``member_sequence`` (every M-th time) then ``agent_sequence`` N times in one
process and stops at the first disagreement, printing its dump
(``agent_loop``);
``--view-race TRIALS [N]`` races a configuration read against a view
change's deletes on this host's CPU, unforced (``view_race``);
``--grpc-loop TRIALS [BUSY]`` runs the gRPC phase's live cluster TRIALS
times beside BUSY threads of Python work, on this host's CPU (``grpc_loop``).
"""

import atexit
import collections
import contextlib
import functools
import gc
import hashlib
import io
import itertools
import json
import os
import queue
import random
import re
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

N_NODES = 100_000
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# non-tensor-core float32 peak of the H100 SXM (NVIDIA data sheet), the
# closest published rate for these integer and boolean operations
PEAK_OPS_PER_S = 67e12
KERNEL_SIZES = (100_000, 1_000_000)
TIMED_RUNS = 5
# bytes each edge must move: four bool inputs + counter in, counter + two
# bools out. The fused phase at the headline (random loss on, gray off,
# K=10): subjects, observers and the draw (4 B each), probe_drop, fd_fail,
# alerted and down_reports in, fd_fail, alerted and down_arrivals out (1 B
# each), plus per node active, alive and drop_prob in and alive out (7 B,
# 0.7 B per edge); fd_bench.fused_bytes counts the other variants, among
# them the windowed policy's 27 + 0.7 B (fd_fail's 2 B swapped for the int32
# fd_hist and the uint8 fd_seen, in and out).
BYTES_PER_EDGE = {"fd_phase_i32": 5 + 4 + 5, "fd_phase_u8": 5 + 1 + 2,
                  "fd_phase_fused": 19 + 7 / 10}
# operations per edge: 2 ANDs and a NOT for the failure, the counter test
# and add, the threshold compare, 2 ANDs and a NOT for new_down, the OR. The
# fused phase adds the node flag tests, the draw compare, the gray path's
# tests and the gather's OR and AND.
# The windowed policy: the node flag tests and the draw compare, the shift,
# OR and mask of the window, the count's add, compare and clamp, the
# population count and the two compares that fire, new_down, the latch and
# the gather's OR and AND.
OPS_PER_EDGE = {"fd_phase_i32": 10, "fd_phase_u8": 10, "fd_phase_fused": 24,
                "fd_phase_fused_windowed": 26}
# the split of the fused phase: the rows take all but the gather's OR and
# AND, plus the bit a slot packs; the gather its OR and AND and the shard
# lookup (a shift, a multiply-high and a shift, a multiply and a subtract)
OPS_PER_EDGE.update({"fd_phase_rows": 23, "fd_phase_rows_windowed": 25, "fd_gather": 7})
# (gray_confirm, rounds_per_interval, random loss): the headline variant
# first, the only one timed
FUSED_VARIANTS = ((0, 1, True), (3, 4, True), (0, 4, False))
# (window W, threshold fraction, rounds_per_interval, random loss): the
# windowed scan's variant first, the only one timed
WINDOW_CASES = tuple(itertools.product((10, 16), (0.4, 0.7), (1, 4), (True, False)))
WINDOWED_RUNS = 3
# the classic fallback scenario: a blind delivery group of CLASSIC_BLIND
# members (the last slots) and CLASSIC_CRASHED crashed members of the other
# group, drawn with numpy from CLASSIC_SEED, which also seeds the simulator.
# With seed 10 the first recovery attempt's coordinator (slot 76160) sits in
# the blind group and collects no promise; the second attempt is a race of
# three coordinators in the other group (slots 42606, 42104, 44042), which
# the highest rank wins.
CLASSIC_SEED = 10
CLASSIC_BLIND = 26_000
CLASSIC_CRASHED = 1_000
# the JAX package's record for that scenario at 100k members (its Simulator
# beside the port's on the CPU, one run, equal in cut, configuration id,
# virtual time and members): cut = the crashed set, decided at round 48 (the
# third batch) plus the exchange's four hops, plus the batching window
CLASSIC_RECORD = {"virtual_time_ms": 52_100, "configuration_id": 4651904502688146028,
                  "membership_size": 99_000, "via_classic_round": True}
# the phase split around the mesh's alert exchange, checked at (C, shards)
SPLIT_CASES = ((100_000, 4), (100_000, 8), (1_000_000, 8))
SPLIT_TIMED_SHARDS = 8  # the timed split: [100_000, 10] over 8 shards
# the meshes of the sharded decisions, every shard on the one card:
# (label, make_mesh keywords, shards)
MESHES = (("4 shards", {"n_devices": 4}, 4), ("8 shards", {"n_devices": 8}, 8),
          ("(2, 2) dcn x ici", {"shape": (2, 2)}, 4))
SHARDED_RUNS = 3  # decisions timed on each mesh, the first warming it
SHARD_SEED = SEED + 8000
SPEC_PAIRS = 3  # speculate on/off pairs of decisions timed per branch
MULTIHOST_SEED = SEED + 7000
# (label, processes, shards a process, ingress loss or 0 for a crash)
MULTIHOST_RUNS = (("(2, 2) ingress loss 1.0", 2, 2, 1.0),
                  ("(4, 1) crash", 4, 1, 0.0))
MULTIHOST_TIMEOUT_S = 300.0  # each child's wall limit
REPLAY_SEED = SEED + 6000
REPLAY_HORIZON_MS = 16_000
PLANES_SEED = SEED + 9000
# the gateway phase: tests/test_gateway.py's GatewayHarness settings, the
# member's identity of the bridge phase, a bound on every wait
GATEWAY_SETTINGS = {"failure_detector_interval_ms": 100, "batching_window_ms": 50,
                    "consensus_fallback_base_delay_ms": 1000}
GATEWAY_PUMP_MS = 50
MEMBER_NODE_ID = (0x1234_5678_9ABC, -0x0FED_CBA9_8765)
GATEWAY_WAIT_S = 180.0
LARGE_FRAME = 64 * 1024  # frames listed one by one: (class, bytes, encode or decode ms)
WIRE_FRAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "torch_wire_frames.json")
PROTO_FRAMES = os.path.join(os.path.dirname(WIRE_FRAMES), "torch_proto_frames.json")


# the FD phase's plain versions draw the round's whole threefry block in
# PyTorch ops, milliseconds a call at [1M, 10]: their CUDA graphs take fewer
# calls
PLAIN_TIMING = dict(reps=4, iters=5)


def _time_ms(fn, reps=24, iters=11):
    """Device time of one call of ``fn`` (``fd_bench.graph_ms``): ``reps``
    calls captured in a CUDA graph, the replay timed with CUDA events, median
    over ``iters`` replays divided by ``reps``; ``fn`` may be a list of calls,
    taken in turn (to rotate input sets)."""
    from rapid_tpu_torch.sim.fd_bench import graph_ms

    return graph_ms(fn, reps, iters)


def _kernel_phase(kernels, device):
    """Each kernel against its plain version, bit for bit, and timed."""
    results = {}
    for name, dtype, hi in (("fd_phase_i32", np.int32, 12), ("fd_phase_u8", np.uint8, 256)):
        plain = getattr(kernels, name.replace("fd_phase", "fd_phase_plain"))
        kernel = getattr(kernels, name)
        sizes = {}
        for c in KERNEL_SIZES:
            rng = np.random.default_rng(c)
            args = [
                torch.from_numpy(a).to(device) for a in (
                    rng.random((c, 10)) < 0.99,
                    rng.random((c, 10)) < 0.98,
                    rng.random((c, 10)) < 0.9,
                    rng.integers(0, hi, size=(c, 10)).astype(dtype),
                    rng.random((c, 10)) < 0.05,
                )
            ]
            got = kernel(*args, 10)
            want = plain(*args, 10)
            torch.cuda.synchronize()
            err = max(
                int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want)
            )
            assert err == 0 and all(torch.equal(g, w) for g, w in zip(got, want)), (
                f"{name} at [{c}, 10] disagrees with its plain version"
            )
            kernel_ms = _time_ms(lambda: kernel(*args, 10))
            plain_ms = _time_ms(lambda: plain(*args, 10))
            bytes_ms = BYTES_PER_EDGE[name] * c * 10 / HBM_BYTES_PER_S * 1e3
            ops_ms = OPS_PER_EDGE[name] * c * 10 / PEAK_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            sizes[f"{c}x10"] = {
                "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            }
            print(f"kernel {name} [{c}, 10]: bit-identical to plain (tolerance 0), "
                  f"kernel {kernel_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us", flush=True)
        results[name] = sizes
    return results


def _unfused_sequence(kernels, args, subj, obs, threshold):
    """The scan-round FD phase that ``fd_phase_fused`` replaces: the round's
    draw (``threefry_draw``), plain ops around ``fd_phase_u8``, then the
    destination gather (random loss on, gray off, one round per interval).
    ``subj``/``obs`` are int64 copies of the adjacency, made once per
    dispatch."""
    (active, alive, drop_prob, _, _, probe_drop, down_reports, key, fd_fail,
     alerted) = args[:10]
    c, k = subj.shape
    _, draw = kernels.threefry_draw(key, c, k)
    alive = alive & active
    edge_live = active[:, None] & active[subj]
    probe_ok = alive[subj] & ~probe_drop & ~(draw < drop_prob[subj])
    observer_up = alive[:, None].expand(c, k).contiguous()
    fd, alerted, new_down = kernels.fd_phase_u8(
        edge_live, observer_up, probe_ok, fd_fail, alerted, threshold)
    down = (new_down.gather(0, obs) | down_reports) & active[:, None]
    return alive, fd, alerted, down


def _outputs_equal(got, want):
    """Every output of two FD phase calls equal (None where both lack it),
    and the largest absolute difference."""
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    assert len(got) == len(want) and all(g is not None for g, _ in pairs)
    return _max_err(*zip(*pairs)), all(torch.equal(g, w) for g, w in pairs)


def _draw_ops_ms(edges):
    """Device ms of threefry's integer operations for ``edges`` words, by the
    pipes that issue them (``threefry_draw``'s bound, ``THREEFRY_*``)."""
    return max(THREEFRY_ALU_OPS_PER_ELEMENT * edges / INT32_OPS_PER_S,
               THREEFRY_OPS_PER_ELEMENT * edges / TWO_PIPE_OPS_PER_S) * 1e3


def _fused_phase(kernels, fd_bench, device):
    """``fd_phase_fused`` against its plain version, bit for bit, in each
    variant, halted (the key kept) and not, at ``fused_case``'s fractional
    drop probabilities; then the headline variant timed cold and hot beside
    its plain version and the unfused sequence, in a round with alerts and
    in a quiet one. The bound: the bytes, or threefry's operations on the
    edges this run's data draws if more."""
    results = {}
    for c in KERNEL_SIZES:
        worst = 0
        for gray, rpi, random in FUSED_VARIANTS:
            args = fd_bench.fused_case(c, c + gray + rpi, device, random)
            for halted in (False, True):
                kw = dict(threshold=10, gray_confirm=gray, gray_warmup=3, rounds_per_interval=rpi,
                          halt=torch.tensor(halted, device=device))
                got = kernels.fd_phase_fused(*args, **kw)
                want = kernels.fd_phase_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                err, equal = _outputs_equal(got, want)
                assert err == 0 and equal, (
                    f"fd_phase_fused at [{c}, 10], gray {gray}, rpi {rpi}, random {random}, "
                    f"halted {halted} disagrees with its plain version")
                assert (got[2] & ~args[9]).any(), "the case should raise alerts"
                assert torch.equal(got[8], args[7]) == halted, "the key split or kept wrongly"
                worst = max(worst, err)
            print(f"kernel fd_phase_fused [{c}, 10] gray {gray} rpi {rpi} random {random}: "
                  f"bit-identical to plain (tolerance 0), the key too, halted and not; "
                  f"{fd_bench.drawn_edges(args, rpi)} edges drawn", flush=True)

        gray, rpi, random = FUSED_VARIANTS[0]
        kw = dict(threshold=10, gray_confirm=gray, gray_warmup=3, rounds_per_interval=rpi)
        # cold: rotate more input sets than the L2 holds (their int64 copies
        # for the unfused sequence on top)
        sets = fd_bench.cold_sets(c, random, device)
        quiet = fd_bench.quiet(sets)
        wide = [(a[3].long(), a[4].long()) for a in sets]
        for case in (sets[0], quiet[0]):
            want = kernels.fd_phase_fused_plain(*case, **kw)
            got = kernels.fd_phase_fused(*case, **kw)
            assert _outputs_equal(got, want)[1], "timed case disagrees"
            got = _unfused_sequence(kernels, case, *wide[0], 10)
            assert all(torch.equal(g, want[i]) for g, i in zip(got, (0, 1, 2, 5))), (
                "the unfused sequence disagrees with the fused plain version")
        assert not (want[2] & ~quiet[0][9]).any(), "the quiet round raised an alert"

        def fused(a):
            return lambda: kernels.fd_phase_fused(*a, **kw)

        def plain(a):
            return lambda: kernels.fd_phase_fused_plain(*a, **kw)

        def unfused(a, w):
            return lambda: _unfused_sequence(kernels, a, *w, 10)

        t = {}
        for label, cases in (("", sets), ("quiet_", quiet)):
            t[f"{label}cold_ms"] = _time_ms([fused(a) for a in cases])
            t[f"{label}hot_ms"] = _time_ms(fused(cases[0]))
            t[f"{label}unfused_cold_ms"] = _time_ms(
                [unfused(a, w) for a, w in zip(cases, wide)])
            t[f"{label}unfused_hot_ms"] = _time_ms(unfused(cases[0], wide[0]))
            t[f"{label}plain_cold_ms"] = _time_ms([plain(a) for a in cases], **PLAIN_TIMING)
            t[f"{label}plain_hot_ms"] = _time_ms(plain(cases[0]), **PLAIN_TIMING)
        nbytes = fd_bench.fused_bytes(c, 10, gray, random)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        quiet_bound_ms = (fd_bench.fused_bytes(c, 10, gray, random, alerts=False)
                          / HBM_BYTES_PER_S * 1e3)
        drawn = fd_bench.drawn_edges(sets[0], rpi)
        ops_ms = (OPS_PER_EDGE["fd_phase_fused"] * c * 10 / PEAK_OPS_PER_S * 1e3
                  + _draw_ops_ms(drawn))
        bound_ms = max(bytes_ms, ops_ms)
        results[f"{c}x10"] = dict(
            t, max_abs_err=worst, ms=t["cold_ms"], plain_ms=t["plain_cold_ms"],
            bound_ms=bound_ms, bound_us=bound_ms * 1e3,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes_per_edge=nbytes / (c * 10), input_sets=len(sets), drawn_edges=drawn,
            draw_ops_ms=_draw_ops_ms(drawn),
            share_of_bound=bound_ms / t["cold_ms"], quiet_bound_ms=quiet_bound_ms,
            quiet_share_of_bound=quiet_bound_ms / t["quiet_cold_ms"],
        )
        print(f"kernel fd_phase_fused [{c}, 10] timed: "
              + ", ".join(f"{key} {ms * 1e3:.2f} us" for key, ms in t.items())
              + f"; bound {bound_ms * 1e3:.2f} us ({nbytes / (c * 10):.2f} B/edge; threefry on "
              f"the {drawn} edges drawn {_draw_ops_ms(drawn) * 1e3:.2f} us), quiet bound "
              f"{quiet_bound_ms * 1e3:.2f} us, {len(sets)} input sets for cold", flush=True)
        del sets, quiet, wide
        torch.cuda.empty_cache()
    return results


def _window_kw(engine, c, w, frac, rpi):
    """The windowed policy's kernel arguments; t from the engine's own
    float64 rounding (``engine.window_params``)."""
    config = engine.SimConfig(capacity=c, fd_policy="windowed", fd_window=w,
                              fd_window_threshold=frac, rounds_per_interval=rpi)
    w, fire, _ = engine.window_params(config)
    return dict(threshold=10, rounds_per_interval=rpi, window=w, window_fire=fire)


def _windowed_phase(kernels, fd_bench, engine, device):
    """``fd_phase_fused`` windowed against its plain version, bit for bit, in
    every case of WINDOW_CASES, from partly filled windows; then the windowed
    scan's variant timed cold and hot beside its plain version, in a round
    with alerts and in a quiet one (no window full)."""
    results = {}
    for c in KERNEL_SIZES:
        worst = 0
        for w, frac, rpi, random in WINDOW_CASES:
            args = fd_bench.fused_case(c, c + w + rpi, device, random)
            hist, seen = fd_bench.window_planes(c, w, c + 2 * w + rpi, device)
            kw = dict(_window_kw(engine, c, w, frac, rpi), fd_hist=hist, fd_seen=seen)
            got = kernels.fd_phase_fused(*args, **kw)
            want = kernels.fd_phase_fused_plain(*args, **kw)
            torch.cuda.synchronize()
            err = max(int((g.to(torch.int64) - x.to(torch.int64)).abs().max())
                      for g, x in zip(got, want))
            assert err == 0 and all(torch.equal(g, x) for g, x in zip(got, want)), (
                f"windowed fd_phase_fused at [{c}, 10], W {w}, threshold {frac}, rpi {rpi}, "
                f"random {random} disagrees with its plain version")
            assert (got[2] & ~args[9]).any(), "the case should raise alerts"
            assert got[1] is args[8], "the windowed policy must leave fd_fail as it came"
            worst = max(worst, err)
            print(f"kernel fd_phase_fused windowed [{c}, 10] W {w} threshold {frac} "
                  f"(t {kw['window_fire']}) rpi {rpi} random {random}: bit-identical to "
                  f"plain (tolerance 0)", flush=True)

        w, frac, rpi, random = WINDOW_CASES[0]
        base = _window_kw(engine, c, w, frac, rpi)
        sets = fd_bench.cold_sets(c, random, device)
        planes = [fd_bench.window_planes(c, w, 9000 + i, device) for i in range(len(sets))]
        # a quiet round: no window full, so no edge can cross
        quiet = [(h, torch.zeros_like(n)) for h, n in planes]
        for case, (h, n) in ((sets[0], planes[0]), (sets[0], quiet[0])):
            want = kernels.fd_phase_fused_plain(*case, fd_hist=h, fd_seen=n, **base)
            got = kernels.fd_phase_fused(*case, fd_hist=h, fd_seen=n, **base)
            assert all(torch.equal(g, x) for g, x in zip(got, want)), "timed case disagrees"
        assert not (want[2] & ~sets[0][9]).any(), "the quiet round raised an alert"

        def call(fn, a, plane):
            return lambda: fn(*a, fd_hist=plane[0], fd_seen=plane[1], **base)

        t = {}
        for label, pl in (("", planes), ("quiet_", quiet)):
            for name, fn, timing in (("", kernels.fd_phase_fused, {}),
                                     ("plain_", kernels.fd_phase_fused_plain, PLAIN_TIMING)):
                t[f"{label}{name}cold_ms"] = _time_ms([call(fn, a, p) for a, p in zip(sets, pl)],
                                                      **timing)
                t[f"{label}{name}hot_ms"] = _time_ms(call(fn, sets[0], pl[0]), **timing)
        nbytes = fd_bench.fused_bytes(c, 10, False, random, window=True)
        quiet_bytes = fd_bench.fused_bytes(c, 10, False, random, alerts=False, window=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_EDGE["fd_phase_fused_windowed"] * c * 10 / PEAK_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        quiet_bound_ms = quiet_bytes / HBM_BYTES_PER_S * 1e3
        results[f"{c}x10"] = dict(
            t, max_abs_err=worst, ms=t["cold_ms"], plain_ms=t["plain_cold_ms"],
            bound_ms=bound_ms, bound_us=bound_ms * 1e3,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes_per_edge=nbytes / (c * 10), input_sets=len(sets),
            share_of_bound=bound_ms / t["cold_ms"], quiet_bound_ms=quiet_bound_ms,
            quiet_share_of_bound=quiet_bound_ms / t["quiet_cold_ms"],
        )
        print(f"kernel fd_phase_fused windowed [{c}, 10] timed (W {w}, t {base['window_fire']}, "
              f"random loss): " + ", ".join(f"{key} {ms * 1e3:.2f} us" for key, ms in t.items())
              + f"; bound {bound_ms * 1e3:.2f} us ({nbytes / (c * 10):.2f} B/edge), share "
              f"{bound_ms / t['cold_ms']:.0%} cold; quiet bound {quiet_bound_ms * 1e3:.2f} us, "
              f"share {quiet_bound_ms / t['quiet_cold_ms']:.0%}; {len(sets)} input sets for cold",
              flush=True)
        del sets, planes, quiet
        torch.cuda.empty_cache()
    return results


def _decide(sim, victims, fault):
    fault(victims)
    t0 = time.perf_counter()
    rec = sim.run_until_decision(max_rounds=16, batch=16)
    sim.ready()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    assert rec is not None, "no decision reached"
    assert sorted(rec.cut.tolist()) == sorted(victims.tolist()), "cut != victims"
    assert rec.membership_size == N_NODES - len(victims)
    assert rec.virtual_time_ms == 11_100, rec.virtual_time_ms
    return rec, wall_ms


def classic_scenario(Simulator, SimConfig, device, n=N_NODES, blind=CLASSIC_BLIND,
                     crashed=CLASSIC_CRASHED, seed=CLASSIC_SEED):
    """A stalled fast round (tests/test_classic_paxos_sim.py at any width):
    the last ``blind`` members form a delivery group that hears no
    broadcast, so it never votes, and live voters stay below the fast
    quorum; ``crashed`` members of the other group are the cut. Returns the
    simulator and the crashed set."""
    sim = Simulator(n, config=SimConfig(capacity=n, groups=2), seed=seed, device=device)
    group_of = np.zeros(n, dtype=np.int32)
    group_of[n - blind:] = 1
    sim.set_delivery_groups(group_of)
    victims = np.sort(np.random.default_rng(seed).choice(n - blind, crashed, replace=False))
    sim.crash(victims)
    sim.drop_broadcasts(1, np.arange(n))
    return sim, victims


def _count_syncs(fn, out=None):
    """Synchronizing CUDA calls made by ``fn`` (torch's sync debug mode:
    device->host fetches and blocking host->device copies); ``fn``'s result
    is appended to ``out`` when given. Only the mode's per-call warning
    counts, not its one-time notice that the mode is a prototype."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if out is not None:
        out.append(result)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def _windowed_decisions(Simulator, engine, kernels, rng, device):
    """100k members under the windowed policy, 1% faulted: crashed (the
    closed form, no kernel) and under ingress loss 1.0 (the scan, the
    windowed kernel every round). Counts are reset just before each decision
    and read just after."""
    config = engine.SimConfig(capacity=N_NODES, fd_policy="windowed")
    n_fail = N_NODES // 100
    out = {}
    for name in ("crash", "ingress_loss"):
        walls = []
        for i in range(WINDOWED_RUNS):
            sim = Simulator(N_NODES, config=config, seed=SEED + 7000 + i, device=device).ready()
            fault = sim.crash if name == "crash" else (
                lambda v, sim=sim: sim.ingress_loss(v, 1.0))
            victims = rng.choice(N_NODES, n_fail, replace=False)
            kernels.reset_launches()
            rec, ms = _decide(sim, victims, fault)
            launches = dict(kernels.LAUNCHES)
            walls.append(ms)
            # the scan executes its whole budget (16 rounds, masked after the
            # decision), one launch of each kernel a round; the closed form
            # launches nothing
            want = {key: 0 for key in launches}
            if name == "ingress_loss":  # the FD kernel splits the key and draws
                want["fd_phase_fused_windowed"] = 16
            assert launches == want, (name, launches)
        out[name] = {"walls_ms": walls, "launches": launches}
        print(f"windowed decision ({'closed form, crash' if name == 'crash' else 'scan, ingress loss 1.0'}): "
              f"{N_NODES} members, {n_fail} faulted, cut ok, virtual {rec.virtual_time_ms} ms, "
              f"walls {[round(w, 3) for w in walls]} ms (the first on a fresh process state), "
              f"kernel launches {launches}", flush=True)
    return out


def _classic_fallback(Simulator, engine, classic, kernels, device):
    """The classic fallback at 100k members (CLASSIC_* above): the fast round
    stalls, the fallback decides. Times each coordinator phase (each ends in
    its one fetch, so the host clock covers the device work) and counts the
    synchronizing calls of each exchange."""
    sim, victims = classic_scenario(Simulator, engine.SimConfig, device)
    sim.ready()
    phases, exchanges = [], []
    coordinator = classic.ClassicCoordinator
    originals = {name: getattr(coordinator, name) for name in ("phase1", "phase2")}

    def timed(name, fn):
        def run(self, *args):
            t0 = time.perf_counter()
            result = fn(self, *args)
            phases.append((name, self.slot, (time.perf_counter() - t0) * 1e3, result))
            return result
        return run

    run_exchange = sim._run_classic_round

    def counted_exchange():
        out = []
        t0 = time.perf_counter()
        syncs = _count_syncs(run_exchange, out)
        exchanges.append({"syncs": syncs, "ms": (time.perf_counter() - t0) * 1e3,
                          "result": out[0]})
        return out[0]

    sim._run_classic_round = counted_exchange
    for name, fn in originals.items():
        setattr(coordinator, name, timed(name, fn))
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        rec = sim.run_until_decision(max_rounds=64, batch=16, classic_fallback_after_rounds=8)
        sim.ready()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in originals.items():
            setattr(coordinator, name, fn)
    launches = dict(kernels.LAUNCHES)
    assert rec is not None and rec.via_classic_round, "no decision through the classic round"
    assert rec.cut.tolist() == victims.tolist(), "cut != crashed set"
    got = {key: getattr(rec, key) for key in CLASSIC_RECORD}
    assert got == CLASSIC_RECORD, (got, CLASSIC_RECORD)
    assert [e["result"][0] for e in exchanges] == [None, 0], exchanges
    print(f"classic fallback: {N_NODES} members, blind group {CLASSIC_BLIND}, "
          f"{CLASSIC_CRASHED} crashed; decided via the classic round, cut ok, "
          f"{rec.membership_size} members, virtual {rec.virtual_time_ms} ms, configuration id "
          f"{rec.configuration_id} (the JAX package's); wall {wall_ms:.3f} ms; exchanges "
          f"(attempt: syncs, ms): {[(i + 1, e['syncs'], round(e['ms'], 3)) for i, e in enumerate(exchanges)]}; "
          f"phases (phase, coordinator slot, ms, result): "
          f"{[(p, s, round(ms, 3), r) for p, s, ms, r in phases]}; kernel launches {launches}",
          flush=True)
    return {"wall_ms": wall_ms, "exchanges": [{k: v for k, v in e.items() if k != "result"}
                                              for e in exchanges],
            "phases": [(p, s, ms) for p, s, ms, _ in phases], "launches": launches}


def _extern_votes(Simulator, SimConfig, device):
    """A stalled fast round (a blind group of 260) that 20 bridged votes of
    blind members, registered as extern votes for the crashed pair, carry
    past the quorum: the extern row pools with group 0's proposal."""
    sim, victims = classic_scenario(Simulator, lambda **kw: SimConfig(extern_proposals=2, **kw),
                                    device, n=1000, blind=260, crashed=2, seed=SEED)
    assert sim.run_until_decision(max_rounds=16, classic_fallback_after_rounds=None) is None

    def register():
        for slot in range(1000 - 260, 1000 - 240):
            sim.set_auto_vote(slot, False)
            assert sim.register_extern_vote(slot, victims)
        assert not sim.register_extern_vote(1000 - 260, victims)  # one vote a sender

    # before any classic round the registrations read nothing back and upload
    # without blocking: no synchronizing call on the card
    syncs = _count_syncs(register) if torch.device(device).type == "cuda" else register()
    assert not syncs, f"extern vote registration made {syncs} synchronizing calls"
    rec = sim.run_until_decision(max_rounds=8, classic_fallback_after_rounds=None)
    return sim, rec, victims


def _cross_check(Simulator, engine, device):
    """The port on the card against the port on the CPU at 1000 members."""
    windowed = engine.SimConfig(capacity=1000, fd_policy="windowed")

    def plain(fault, config=None):
        def run(dev):
            sim = Simulator(1000, config=config, seed=SEED, device=dev)
            fault(sim)
            return sim, sim.run_until_decision(max_rounds=16, batch=16)
        return run

    def classic(dev):
        sim, _ = classic_scenario(Simulator, engine.SimConfig, dev, n=1000, blind=260,
                                  crashed=10)
        return sim, sim.run_until_decision(max_rounds=64, batch=16,
                                           classic_fallback_after_rounds=8)

    def extern(dev):
        sim, rec, _ = _extern_votes(Simulator, engine.SimConfig, dev)
        return sim, rec

    scenarios = {
        "crash": plain(lambda s: s.crash(np.arange(0, 1000, 97))),
        "ingress_loss_1.0": plain(lambda s: s.ingress_loss(np.arange(5, 1000, 89), 1.0)),
        "windowed_crash": plain(lambda s: s.crash(np.arange(0, 1000, 97)), windowed),
        "windowed_ingress_loss_1.0": plain(
            lambda s: s.ingress_loss(np.arange(5, 1000, 89), 1.0), windowed),
        "classic_fallback": classic,
        "extern_votes": extern,
    }
    for name, run in scenarios.items():
        outs = []
        for dev in ("cpu", device):
            sim, rec = run(dev)
            assert rec is not None, f"cross-check {name}: no decision on {dev}"
            outs.append(((rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms,
                          rec.via_classic_round), engine.state_to_numpy(sim.state)))
        assert outs[0][0] == outs[1][0], f"cross-check {name}: records differ"
        for field, value in outs[0][1].items():
            assert np.array_equal(outs[1][1][field], value), f"cross-check {name}: {field}"
        assert outs[0][0][3] == (name == "classic_fallback"), name
        print(f"cross-check {name}: card == cpu at 1000 members (cut {len(outs[0][0][0])} "
              f"members, virtual {outs[0][0][2]} ms)", flush=True)


def _split_kw(engine, fd_bench, policy, c, seed, device):
    """``fd_phase_rows``' policy keywords: the cumulative counter, the gray
    path with 4 rounds per interval, or the window (W 10, 40%) from partly
    filled windows."""
    if policy == "cumulative":
        return dict(threshold=10)
    if policy == "gray":
        return dict(threshold=10, gray_confirm=3, gray_warmup=3, rounds_per_interval=4)
    hist, seen = fd_bench.window_planes(c, 10, seed, device)
    return dict(_window_kw(engine, c, 10, 0.4, 1), fd_hist=hist, fd_seen=seen)


def _max_err(got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want) if w is not None)


def _split_round(kernels, calls, bits, args, rows, halt):
    """One round of the sharded FD phase: the ``fd_phase_rows`` calls of
    ``calls`` into the segments of ``bits`` (one call over every shard, as a
    device that holds them all makes it, or one call a shard), then
    ``fd_gather`` on home."""
    for a, kw in calls:
        kernels.fd_phase_rows(*a, **kw, halt=halt)
    return kernels.fd_gather(args[0], args[4], args[6], bits, rows)


def _assert_halted(kernels, fd_bench, args, kw, shards, halt, where):
    """The per-device call halted: every plane as it came in, every segment
    zero, the key kept, and equal to its plain version halted."""
    calls, bits = fd_bench.split_case(args, kw, shards)
    merged, merged_kw = fd_bench.device_call(calls)
    got, key = kernels.fd_phase_rows(*merged, **merged_kw, halt=halt)
    plain_calls, plain_bits = fd_bench.split_case(args, kw, shards)
    plain_merged, plain_kw = fd_bench.device_call(plain_calls)
    plain, plain_key = kernels.fd_phase_rows_plain(*plain_merged, **plain_kw, halt=halt)
    torch.cuda.synchronize()
    assert torch.equal(bits, plain_bits) and not bits.any(), f"halted bitset not zero at {where}"
    assert torch.equal(key, args[7]) and torch.equal(plain_key, args[7]), (
        f"a halted call moved the key at {where}")
    for (a, a_kw), g, p in zip(calls, got, plain):
        planes_in = (a[6], a[7], a[8], a[9], a_kw["fd_hist"], a_kw["fd_seen"])
        for i, x, y in zip(planes_in, g, p):
            assert (i is None and x is None and y is None) or (
                torch.equal(x, i) and torch.equal(y, i)), f"a halted plane moved at {where}"


def _split_phase(kernels, fd_bench, engine, device):
    """The per-device ``fd_phase_rows`` over every shard (each shard's draw
    folded with its index, as on a mesh), the exchange into one bitset and
    ``fd_gather``, each kernel against its plain version, bit for bit (the
    new key too), in every case of SPLIT_CASES x {cumulative, gray,
    windowed} x {random loss, none}; without random loss also against
    ``fd_phase_fused_plain`` over the whole array, and with it halted
    (every plane as it came in, no bit, the key kept); then at [100_000,
    10] over 8 shards timed cold (input sets rotated past the L2): the
    per-device call, one shard's call alone, and 8 one-shard calls, each
    round with ``fd_gather``, beside ``fd_phase_fused`` on the same
    inputs."""
    worst = {"fd_phase_rows": 0, "fd_phase_rows_windowed": 0, "fd_gather": 0}
    running = torch.zeros((), dtype=torch.bool, device=device)
    halted = torch.ones((), dtype=torch.bool, device=device)
    for c, shards in SPLIT_CASES:
        for policy in ("cumulative", "gray", "windowed"):
            for random in (True, False):
                args = fd_bench.fused_case(c, c + shards + len(policy), device, random)
                kw = _split_kw(engine, fd_bench, policy, c, c + shards, device)
                calls, bits = fd_bench.split_case(args, kw, shards)
                got = fd_bench.run_split(calls, bits, args, halt=running)
                plain_calls, plain_bits = fd_bench.split_case(args, kw, shards)
                plain = fd_bench.run_split(plain_calls, plain_bits, args, kernel=False,
                                           halt=running)
                # with random loss each shard draws under the probe key folded
                # with its index, other bits than the fused phase's
                fused = None if random else kernels.fd_phase_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                where = f"[{c}, 10] over {shards} shards, {policy}, random {random}"
                for i, name in enumerate(("alive", "fd_fail", "alerted", "fd_streak", "fd_ok",
                                          "down_arrivals", "fd_hist", "fd_seen", "key")):
                    if i == 0 or plain[i] is None:
                        continue
                    assert torch.equal(got[i], plain[i]), f"split {name} != its plain at {where}"
                    assert fused is None or torch.equal(got[i], fused[i]), (
                        f"split {name} != fused plain at {where}")
                assert torch.equal(bits, plain_bits), f"bitset != plain at {where}"
                assert (got[2] & ~args[9]).any(), "the case should raise alerts"
                rows_err = max(_max_err(got[1:5] + got[6:], plain[1:5] + plain[6:]),
                               _max_err([bits], [plain_bits]))
                rows_name = "fd_phase_rows_windowed" if policy == "windowed" else "fd_phase_rows"
                worst[rows_name] = max(worst[rows_name], rows_err)
                worst["fd_gather"] = max(worst["fd_gather"], _max_err([got[5]], [plain[5]]))
                print(f"split {where}: one fd_phase_rows call over {shards} shards (each "
                      f"shard's draw folded with its index) + exchange + fd_gather "
                      f"bit-identical to their plain versions, the key too"
                      + ("" if random else " and to fd_phase_fused_plain")
                      + " (tolerance 0)", flush=True)
                if random:
                    _assert_halted(kernels, fd_bench, args, kw, shards, halted, where)
                    print(f"split {where}, halted: every plane as it came in, no bit, the key "
                          f"kept, bit-identical to the plain version (tolerance 0)", flush=True)
                del args, calls, bits, plain_calls, plain_bits, got, plain, fused
        torch.cuda.empty_cache()

    c, shards = KERNEL_SIZES[0], SPLIT_TIMED_SHARDS
    rows = c // shards
    sets = fd_bench.cold_sets(c, True, device)
    timed = {}
    for policy in ("cumulative", "windowed"):
        kws = [_split_kw(engine, fd_bench, policy, c, 9000 + i, device) for i in range(len(sets))]
        cases = [fd_bench.split_case(a, kw, shards) for a, kw in zip(sets, kws)]
        merged = [fd_bench.device_call(calls) for calls, _ in cases]
        for a, (calls, bits) in zip(sets, cases):
            # the bitsets of a round with alerts; one call a shard gives the same
            one_by_one = fd_bench.run_split(calls, bits, a, per_device=False, halt=running)
            per_shard_bits = bits.clone()
            together = fd_bench.run_split(calls, bits, a, halt=running)
            torch.cuda.synchronize()
            assert torch.equal(bits, per_shard_bits) and all(
                (x is None and y is None) or torch.equal(x, y)
                for x, y in zip(one_by_one[1:], together[1:])), "one call a shard disagrees"
        every_shard = [(a, kw) for calls, _ in cases for a, kw in calls]
        name = "fd_phase_rows_windowed" if policy == "windowed" else "fd_phase_rows"

        def device_call(m, fn=kernels.fd_phase_rows):
            return lambda: fn(*m[0], **m[1], halt=running)

        def shard_call(a, kw, fn=kernels.fd_phase_rows):
            return lambda: fn(*a, **kw, halt=running)

        def shard_calls(calls):
            return lambda: [kernels.fd_phase_rows(*a, **kw, halt=running) for a, kw in calls]

        def round_(a, calls, bits):
            return lambda: _split_round(kernels, calls, bits, a, rows, running)

        # cold: every set in turn, more than the L2 holds
        t = {"ms": _time_ms([device_call(m) for m in merged]),
             "hot_ms": _time_ms(device_call(merged[0])),
             "plain_ms": _time_ms([device_call(m, kernels.fd_phase_rows_plain) for m in merged],
                                  **PLAIN_TIMING),
             "one_shard_ms": _time_ms([shard_call(a, kw) for a, kw in every_shard],
                                      reps=len(every_shard)),
             "per_shard_calls_ms": _time_ms([shard_calls(calls) for calls, _ in cases]),
             "round_ms": _time_ms([round_(a, [m], bits)
                                   for a, m, (_, bits) in zip(sets, merged, cases)]),
             "per_shard_round_ms": _time_ms([round_(a, calls, bits)
                                             for a, (calls, bits) in zip(sets, cases)]),
             "fused_ms": _time_ms([lambda a=a, kw=kw: kernels.fd_phase_fused(*a, **kw)
                                   for a, kw in zip(sets, kws)])}
        windowed = policy == "windowed"
        nbytes = fd_bench.rows_bytes(c, rows, 10, False, True, window=windowed, shards=shards)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_EDGE[name] * c * 10 / PEAK_OPS_PER_S * 1e3
        one_bytes_ms = (fd_bench.rows_bytes(c, rows, 10, False, True, window=windowed)
                        / HBM_BYTES_PER_S * 1e3)
        t.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 one_shard_bound_ms=max(one_bytes_ms, ops_ms / shards),
                 max_abs_err=worst[name], shape=[c, 10], shards=shards)
        timed[name] = t
        if policy == "cumulative":
            gather = {"ms": _time_ms([lambda a=a, b=b: kernels.fd_gather(a[0], a[4], a[6], b, rows)
                                      for a, (_, b) in zip(sets, cases)]),
                      "plain_ms": _time_ms([lambda a=a, b=b: kernels.fd_gather_plain(
                          a[0], a[4], a[6], b, rows) for a, (_, b) in zip(sets, cases)])}
            # no single PyTorch call reads the packed bitset, ORs the reports and
            # masks by active; the gather alone is one call on the unpacked bits
            unpacked = [(torch.rand(c, 10, device=device) < 0.05, a[4].long()) for a in sets]
            gather["gather_only_ms"] = _time_ms(
                [lambda nd=nd, obs=obs: torch.gather(nd, 0, obs) for nd, obs in unpacked])
            del unpacked
            nbytes = fd_bench.gather_bytes(c, shards, 10)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = OPS_PER_EDGE["fd_gather"] * c * 10 / PEAK_OPS_PER_S * 1e3
            gather.update(bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          max_abs_err=worst["fd_gather"], shape=[c, 10], shards=shards)
            timed["fd_gather"] = gather
        print(f"split timed, {policy}, [{c}, 10] over {shards} shards, random loss, cold over "
              f"{len(sets)} input sets: fd_phase_rows over all {shards} shards in one call "
              f"{t['ms'] * 1e3:.2f} us (hot {t['hot_ms'] * 1e3:.2f}, plain "
              f"{t['plain_ms'] * 1e3:.2f}, bound {t['bound_ms'] * 1e3:.2f}); one shard alone "
              f"{t['one_shard_ms'] * 1e3:.2f} us (bound {t['one_shard_bound_ms'] * 1e3:.2f}); "
              f"{shards} one-shard calls {t['per_shard_calls_ms'] * 1e3:.2f} us; a whole round "
              f"(+ fd_gather) {t['round_ms'] * 1e3:.2f} us, with {shards} one-shard calls "
              f"{t['per_shard_round_ms'] * 1e3:.2f} us, against fd_phase_fused "
              f"{t['fused_ms'] * 1e3:.2f} us", flush=True)
        del cases, merged, every_shard, kws
    g = timed["fd_gather"]
    print(f"split timed: fd_gather over {shards} segments {g['ms'] * 1e3:.2f} us (plain "
          f"{g['plain_ms'] * 1e3:.2f}, bound {g['bound_ms'] * 1e3:.2f}); torch.gather of the "
          f"unpacked [{c}, 10] bits alone {g['gather_only_ms'] * 1e3:.2f} us", flush=True)
    del sets
    torch.cuda.empty_cache()
    return timed


def _record(rec):
    return (rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms, rec.membership_size)


def _planes_fault(sim, branch):
    """The fault of a branch: a crash (closed form), or a crash under
    ingress loss 1.0 on the same members (the scan, whose random loss has no
    closed form). Speculation predicts crashed and leaving members, so both
    give it a prediction."""
    if branch == "closed form":
        return sim.crash

    def crash_and_loss(victims):
        sim.crash(victims)
        sim.ingress_loss(victims, 1.0)
    return crash_and_loss


def _speculation_pairs(Simulator, rng, device):
    """Each branch's decision with ``speculate`` on and off on the same
    fresh members and victims, SPEC_PAIRS alternating pairs (on-off,
    off-on, ...): identical records, hits only when on, the decision's wall
    and its host view change (``_apply_view_change``, whose device work runs
    on after it returns) side by side, and the syncs of one decision each
    way."""
    out = {}
    for branch in ("closed form", "scan"):
        rows = {True: [], False: []}
        for i in range(SPEC_PAIRS):
            victims = rng.choice(N_NODES, N_NODES // 100, replace=False)
            records = {}
            for speculate in ((True, False) if i % 2 == 0 else (False, True)):
                sim = Simulator(N_NODES, seed=PLANES_SEED + i, speculate=speculate,
                                device=device).ready()
                view_ms = []
                apply = sim._apply_view_change

                def timed_apply(*args, apply=apply, view_ms=view_ms):
                    t0 = time.perf_counter()
                    rec = apply(*args)
                    view_ms.append((time.perf_counter() - t0) * 1e3)
                    return rec

                sim._apply_view_change = timed_apply
                _planes_fault(sim, branch)(victims)
                t0 = time.perf_counter()
                rec = sim.run_until_decision(max_rounds=16, batch=16)
                sim.ready()
                wall = (time.perf_counter() - t0) * 1e3
                assert rec is not None and sorted(rec.cut.tolist()) == sorted(victims.tolist())
                hits = (sim.metrics.get("speculation_hits_config_id"),
                        sim.metrics.get("speculation_hits_fresh_state"))
                assert (hits == (1, 1)) if speculate else (hits == (0, 0)), (branch, hits)
                records[speculate] = _record(rec)
                rows[speculate].append({"wall_ms": wall, "view_change_ms": view_ms[0]})
            assert records[True] == records[False], (branch, records)
        syncs = {}
        for speculate in (True, False):
            sim = Simulator(N_NODES, seed=PLANES_SEED + 99, speculate=speculate,
                            device=device).ready()
            _planes_fault(sim, branch)(rng.choice(N_NODES, N_NODES // 100, replace=False))
            syncs[speculate] = _count_syncs(
                lambda: sim.run_until_decision(max_rounds=16, batch=16))
        assert syncs == {True: 1, False: 1}, (branch, syncs)
        out[branch] = {"on": rows[True], "off": rows[False], "syncs": syncs}
        print(f"speculation, {branch}: {SPEC_PAIRS} alternating pairs on the same members and "
              f"victims, records identical, hits (config id, fresh state) 1 and 1 when on, 0 "
              f"when off; walls on {[round(r['wall_ms'], 3) for r in rows[True]]} ms, off "
              f"{[round(r['wall_ms'], 3) for r in rows[False]]} ms; host view change on "
              f"{[round(r['view_change_ms'], 3) for r in rows[True]]} ms, off "
              f"{[round(r['view_change_ms'], 3) for r in rows[False]]} ms; syncs per decision "
              f"on {syncs[True]}, off {syncs[False]}", flush=True)
    return out


def _everything_on(Simulator, observability, ProfilingSettings, seed, device):
    sim = Simulator(N_NODES, seed=seed, speculate=True, metrics=observability.Metrics(),
                    tracer=observability.Tracer(plane="sim", track="sim"), device=device).ready()
    return sim, sim.enable_profiling(ProfilingSettings(enabled=True))


def _timed_windows(Simulator, observability, jitwatch, ProfilingSettings, rng, device):
    """A decision of each branch with speculation, metrics, tracer and
    profiling (1 dispatch in 16 sampled) on, inside ``jitwatch.timed_window``
    (sync debug mode "error"): nothing may raise, no violation is recorded,
    and both speculation hits land. The speculation worker alone inside a
    timed window, with no audited seam lifting the mode while it runs. The
    same decision on a twin simulator counted under "warn": every counted
    sync is audited. Then a second decision on the twin, whose dispatch is
    not sampled."""
    out = {}
    for branch in ("closed form", "scan"):
        victims = rng.choice(N_NODES, N_NODES // 100, replace=False)
        solo = Simulator(N_NODES, seed=PLANES_SEED + 51, speculate=True, device=device).ready()
        _planes_fault(solo, branch)(victims)
        with jitwatch.timed_window(f"{branch} speculation worker"):
            solo._speculate_view_change().join()
        assert solo._spec is not None and not jitwatch.violations(), jitwatch.violations()

        sim, prof = _everything_on(Simulator, observability, ProfilingSettings,
                                   PLANES_SEED + 50, device)
        _planes_fault(sim, branch)(victims)
        before = jitwatch.sync_counts()
        with jitwatch.timed_window(f"{branch} decision"):
            rec = sim.run_until_decision(max_rounds=16, batch=16)
        audited = _diff(jitwatch.sync_counts(), before)
        hits = (sim.metrics.get("speculation_hits_config_id"),
                sim.metrics.get("speculation_hits_fresh_state"))
        assert rec is not None and prof.samples == 1 and hits == (1, 1), (prof.samples, hits)
        assert not jitwatch.violations(), jitwatch.violations()

        twin, twin_prof = _everything_on(Simulator, observability, ProfilingSettings,
                                         PLANES_SEED + 50, device)
        _planes_fault(twin, branch)(victims)
        before = jitwatch.sync_counts()
        counted = _count_syncs(lambda: twin.run_until_decision(max_rounds=16, batch=16))
        twin_audited = _diff(jitwatch.sync_counts(), before)
        # an explicit device synchronize (a drain) may escape the debug mode;
        # what it counts must be audited either way. The profiler drains once
        # a replay, three a turn; a turn whose times do not rise is taken
        # again, and each profiler counts the turns it took
        drains = sum(v for k, v in audited.items() if k != "sim.decision_words")
        turns = (prof.turns, twin_prof.turns)
        assert [d.get("sim.profile.sample", 0) for d in (audited, twin_audited)] == [
            3 * t for t in turns], (branch, turns, audited, twin_audited)
        assert {**twin_audited, "sim.profile.sample": 0} == {
            **audited, "sim.profile.sample": 0} and counted in (
            audited["sim.decision_words"], audited["sim.decision_words"] + drains), (
            branch, counted, audited, twin_audited)
        _planes_fault(twin, branch)(rng.choice(twin.members(), 10, replace=False))
        before = jitwatch.sync_counts()
        unsampled = _count_syncs(lambda: twin.run_until_decision(max_rounds=16, batch=16))
        unsampled_audited = _diff(jitwatch.sync_counts(), before)
        assert twin_prof.samples == 1 and unsampled == 1 and unsampled_audited == {
            "sim.decision_words": 1}, (unsampled, unsampled_audited)
        out[branch] = {"audited": audited, "counted": counted, "unsampled_syncs": unsampled,
                       "metrics": sim.metrics.snapshot()}
        print(f"timed window, {branch}: the speculation worker alone and a decision with "
              f"speculation (hits {hits}), metrics, tracer and profiling on, sync "
              f"debug mode error, nothing raised, no violation; syncs in the sampled decision counted "
              f"{counted}, audited {audited}; in the next, unsampled decision counted "
              f"{unsampled}, audited {unsampled_audited}; counters {sim.metrics.snapshot()}",
              flush=True)
    return out


def _diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


PROFILE_DECISIONS = 6  # in-loop sampled decisions: the first in one dispatch, the rest a round each
PROFILE_REPEATS = 5  # the best-of-N sample that holds every phase > 0
PROFILE_MIN_SAMPLES = 50  # one-shot in-loop samples over those decisions, no phase of any at 0
PROFILE_LOSSES = ((0.5, N_NODES // 1000), (1.0, N_NODES // 100))  # (p, members): on == off


def _profiled_policy(Simulator, engine, kernels, ProfilingSettings, rng, device, policy):
    """One 100k scan-path decision with every dispatch sampled under the FD
    ``policy``: samples, the four phases, the prefixes' kernel launches
    (16 and one a replay of the FD kernel, which splits the key and draws,
    and none of ``threefry_draw``: 3 a turn the profiler counts, more than
    one turn a sample only where a turn was taken again; a captured prefix
    counts once a replay, not at capture). On the first decision's pre-dispatch state, a fresh
    profiler's best-of-``PROFILE_REPEATS`` sample must hold every phase
    > 0, its captured full step must equal the eager ``engine.step`` of the
    same state, bit for bit, the key included, and the state's key must
    stay where it was; the same state's host walls (the eager prefixes up to
    a drain, the CPU's source) are printed beside the device times."""
    from rapid_tpu_torch.observability import Metrics
    from rapid_tpu_torch.profiling import phases

    windowed = policy == "windowed"
    counter = "fd_phase_fused_windowed" if windowed else "fd_phase_fused"
    other = "fd_phase_fused" if windowed else "fd_phase_fused_windowed"
    config = engine.SimConfig(capacity=N_NODES, fd_policy=policy)
    sim = Simulator(N_NODES, config=config, seed=PLANES_SEED + 70, device=device).ready()
    prof = sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
    fault = _planes_fault(sim, "scan")
    fault(rng.choice(N_NODES, N_NODES // 100, replace=False))
    inputs = sim._const_inputs(None)
    state = sim.state
    prefix_ms = []  # every in-loop prefix time, in the order sample() takes them
    segments = []  # the caching allocator's new device segments (cudaMalloc) in each
    in_loop = []  # the phases of every in-loop sample
    timed_ms, sample = prof._timed_ms, prof.sample

    def allocated():
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def recorded(*args):
        before = allocated()
        prefix_ms.append(timed_ms(*args))
        segments.append(allocated() - before)
        return prefix_ms[-1]

    def kept(*args, **kw):
        in_loop.append(sample(*args, **kw))
        return in_loop[-1]

    prof._timed_ms, prof.sample = recorded, kept
    kernels.reset_launches()
    rec = sim.run_until_decision(max_rounds=16, batch=16)
    sim.ready()
    launches = dict(kernels.LAUNCHES)
    totals, samples = prof.attribution(), prof.samples
    assert rec is not None and samples >= 1, samples
    assert totals["host_transfer"] > 0, totals
    replays = len(prefix_ms)
    assert replays == 3 * prof.turns >= 3 * samples and launches[counter] == 16 + replays, (
        replays, prof.turns, launches)
    assert launches["threefry_draw"] == 0 and launches[other] == 0, launches

    before = state.rng_key.clone()
    fresh = phases.PhaseProfiler(Metrics(), ProfilingSettings(enabled=True))
    best = fresh.sample(sim.config, state, inputs, True, repeats=PROFILE_REPEATS)
    assert all(best[p] > 0 for p in phases.DEVICE_PHASES), best
    assert torch.equal(state.rng_key, before), "a sample moved the state's key"
    captured = fresh._captured[phases._class_key(sim.config, state, inputs, True)]
    eager = engine.step(sim.config, state, inputs, True)
    mismatched = [f for f, t in phases._tensors(eager).items()
                  if not torch.equal(getattr(captured.outputs[2], f), t)]
    assert not mismatched, f"captured step != eager step in {mismatched}"
    walls = phases.PhaseProfiler(Metrics(), ProfilingSettings(enabled=True))
    walls._timed_ms = phases.wall_ms  # the CPU's source: host walls up to a drain
    host = walls.sample(sim.config, state, inputs, True, repeats=PROFILE_REPEATS)
    per_sample = {p: totals[p] / samples for p in phases.DEVICE_PHASES}
    rounded = lambda d: {p: round(v, 4) for p, v in d.items()}  # noqa: E731
    print(f"profiling, {policy} scan path, every dispatch sampled: {samples} sample(s), device "
          f"phase ms a sample {rounded(per_sample)}, host transfer "
          f"{totals['host_transfer']:.3f} ms over {sim.metrics.get('device_dispatches')} "
          f"dispatch(es); {counter} launches {launches[counter]} (16 in the dispatch + one a "
          f"replay, {replays} replays), threefry_draw {launches['threefry_draw']}; "
          f"best of {PROFILE_REPEATS} turns on the pre-dispatch state: device (graph replays) "
          f"{rounded(best)}, host walls of the same prefixes {rounded(host)}; the captured step "
          f"== the eager step, every field, the key included; the state's key untouched",
          flush=True)
    return {"sim": sim, "prof": prof, "fault": fault, "prefix_ms": prefix_ms,
            "segments": segments, "in_loop": in_loop, "launches": launches,
            "samples": samples, "attribution": totals, "per_sample": per_sample,
            "best_of": best, "host_walls": host, "state": state, "inputs": inputs}


def _profiling(Simulator, engine, kernels, ProfilingSettings, rng, device):
    """``enable_profiling`` sampling every dispatch on the 100k scan path
    under both FD policies (``_profiled_policy``); then, cumulative, further
    decisions a round a dispatch, every one sampled once (one shot, the
    in-loop default): at least ``PROFILE_MIN_SAMPLES`` samples, no phase of
    any at 0, ``fd_phase_fused`` launched once a dispatch (its round) and
    once a replay, ``threefry_draw`` never; the GPU ops of one step and of
    each prefix; and the decisions with profiling on equal those with it off
    under ingress loss below 1.0 and at 1.0 (cut, configuration id, virtual
    ms)."""
    from rapid_tpu_torch.profiling import phases
    from rapid_tpu_torch.sim.profile_decision import profile_gpu

    run = _profiled_policy(Simulator, engine, kernels, ProfilingSettings, rng, device,
                           "cumulative")
    windowed = _profiled_policy(Simulator, engine, kernels, ProfilingSettings, rng, device,
                                "windowed")
    sim, prof, fault = run["sim"], run["prof"], run["fault"]
    state, inputs = run["state"], run["inputs"]
    ops = {name: profile_gpu(lambda fn=fn: fn(sim.config, state, inputs, True))["kernels"]
           for name, fn in (("step", engine.step), ("step_cut_detector", engine.step_cut_detector),
                            ("step_fd_scan", engine.step_fd_scan))}
    prefix_ms = run["prefix_ms"]
    for _ in range(PROFILE_DECISIONS - 1):
        fault(rng.choice(sim.members(), N_NODES // 100, replace=False))
        taken, replays, turns = prof.samples, len(prefix_ms), prof.turns
        kernels.reset_launches()
        assert sim.run_until_decision(max_rounds=16, batch=1) is not None
        sampled, replays = prof.samples - taken, len(prefix_ms) - replays
        assert replays == 3 * (prof.turns - turns) and kernels.LAUNCHES[
            "fd_phase_fused"] == sampled + replays and kernels.LAUNCHES["threefry_draw"] == 0, (
            sampled, replays, kernels.LAUNCHES)
    in_loop = run["in_loop"]
    assert len(prefix_ms) == 3 * prof.turns, (len(prefix_ms), prof.turns)
    zero = [s for s in in_loop if min(s[p] for p in phases.DEVICE_PHASES) <= 0]
    assert len(in_loop) >= PROFILE_MIN_SAMPLES and not zero, (len(in_loop), zero[:3])
    grown = [tuple(run["segments"][i:i + 3]) for i in range(0, len(prefix_ms), 3)]
    least = {p: round(min(s[p] for s in in_loop), 4) for p in phases.DEVICE_PHASES}
    print(f"profiling, in-loop one-shot samples over {PROFILE_DECISIONS} decisions (the "
          f"first in one dispatch, the rest a round a dispatch): {len(in_loop)} samples, "
          f"{len(zero)} with a phase at 0, least phase ms {least}; {len(prefix_ms)} "
          f"replays ({prof.turns - len(in_loop)} turns taken again); first prefix ms "
          f"(step_fd_scan, step_cut_detector, step) {[round(ms, 4) for ms in prefix_ms[:3]]}; "
          f"new device segments (cudaMalloc) in a prefix: {sum(map(sum, grown))} over "
          f"{len(grown)} samples; GPU ops of one round: {ops}", flush=True)

    on_off = {}
    for loss, members in PROFILE_LOSSES:
        lossy = rng.choice(N_NODES, members, replace=False)
        records = []
        for profiled in (False, True):
            twin = Simulator(N_NODES, seed=PLANES_SEED + 75, device=device).ready()
            if profiled:
                twin.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
            twin.ingress_loss(lossy, loss)
            rec = twin.run_until_decision(max_rounds=128, batch=16)
            assert rec is not None, (loss, profiled)
            records.append((sorted(int(c) for c in rec.cut), int(rec.configuration_id),
                            int(rec.virtual_time_ms)))
        assert records[0] == records[1], (loss, records)
        on_off[loss] = {"cut": len(records[0][0]), "configuration_id": records[0][1],
                        "virtual_ms": records[0][2]}
    print(f"profiling on == off, ingress loss on {[m for _, m in PROFILE_LOSSES]} members at "
          f"{[p for p, _ in PROFILE_LOSSES]}: {on_off}", flush=True)
    keep = ("launches", "samples", "attribution", "per_sample", "best_of", "host_walls")
    return {"cumulative": {k: run[k] for k in keep},
            "windowed": {k: windowed[k] for k in keep},
            "in_loop_samples": len(in_loop), "in_loop_zero": len(zero), "least": least,
            "gpu_ops": ops, "new_segments": sum(map(sum, grown)), "on_off": on_off}


def _device_trace(Simulator, observability, rng, device):
    """``observability.device_trace`` around one scan-path decision: the
    Chrome trace must name ``fd_phase_fused``."""
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trace")
    sim = Simulator(N_NODES, seed=PLANES_SEED + 80, device=device).ready()
    _planes_fault(sim, "scan")(rng.choice(N_NODES, N_NODES // 100, replace=False))
    with observability.device_trace(trace_dir):
        rec = sim.run_until_decision(max_rounds=16, batch=16)
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = sum(e.get("name") == "fd_phase_fused" for e in events)
    passes = sum(e.get("cat") == "kernel" and "observer_pass" in e.get("name", "")
                 for e in events)
    assert rec is not None and ranges >= 16, (ranges, passes)
    print(f"device trace: {len(events)} events in {trace_dir}/trace.json, {ranges} "
          f"fd_phase_fused ranges, {passes} observer_pass kernels", flush=True)
    return {"events": len(events), "fd_phase_fused_ranges": ranges}


def _profile(fn):
    """``profile_decision.profile_gpu`` with the device µs of the FD passes:
    ``rows_us`` (the node pass and the observer pass, ``rows_pass`` in
    ``fd_phase_rows``, ``observer_pass`` in ``fd_phase_fused``) and
    ``gather_us``."""
    from rapid_tpu_torch.sim.profile_decision import profile_gpu

    prof = profile_gpu(fn, ("node_pass", "observer_pass", "rows_pass", "gather_pass"))
    prof["rows_us"] = (prof.pop("node_pass_us") + prof.pop("observer_pass_us")
                       + prof.pop("rows_pass_us"))
    prof["gather_us"] = prof.pop("gather_pass_us")
    return prof


def _sharded_decisions(Simulator, engine, shard, kernels, rng, device):
    """The headline fault (100k members, 1% crashed, ``run_until_decision(16,
    16)``) through ``Simulator(mesh=...)`` on each mesh of MESHES, every shard
    on this card, beside the single-device closed form and scan path (ingress
    loss 1.0) of the same members; the same members under ingress loss 1.0
    on 8 shards; and the windowed policy on 4 shards. Counts are reset just
    before each decision and read just after."""
    victims = rng.choice(N_NODES, N_NODES // 100, replace=False)
    card = torch.device(device.type, torch.cuda.current_device())

    def fresh(**kw):
        return Simulator(N_NODES, seed=SHARD_SEED, **kw).ready()

    def decide(sim, fault="crash"):
        kernels.reset_launches()
        rec, ms = _decide(sim, victims, sim.crash if fault == "crash" else
                          (lambda v: sim.ingress_loss(v, 1.0)))
        return rec, ms, dict(kernels.LAUNCHES)

    out = {"single": {}}
    for branch, fault in (("closed form", "crash"), ("scan", "ingress_loss")):
        rec, ms, launches = decide(fresh(device=device), fault)
        sim = fresh(device=device)
        (sim.crash if fault == "crash" else (lambda v: sim.ingress_loss(v, 1.0)))(victims)
        prof = _profile(lambda: sim.run_until_decision(max_rounds=16, batch=16))
        out["single"][branch] = {"wall_ms": ms, "launches": launches, **prof}
        if branch == "closed form":
            reference_id = rec.configuration_id
        else:
            # the scan dispatch alone, to set the mesh dispatch's copies beside
            sim = fresh(device=device)
            sim.ingress_loss(victims, 1.0)
            inputs = sim._const_inputs(None)
            sim.ready()
            scan_dispatch = _profile(lambda: engine.run_rounds_const(
                sim.config, sim.state, inputs, 16, True))
            out["single"][branch]["dispatch"] = scan_dispatch
        print(f"single device, {branch}: cut ok, virtual {rec.virtual_time_ms} ms, wall "
              f"{ms:.3f} ms, GPU ops {prof['kernels']} (and {prof['annotations']} named "
              f"ranges), device busy {prof['device_busy_ms']:.3f} ms, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)

    for label, spec, size in MESHES:
        mesh = shard.make_mesh(devices=[card] * size, **spec)
        assert set(mesh.device_list) == {card} and mesh.size == size
        walls = []
        for _ in range(SHARDED_RUNS):
            rec, ms, launches = decide(fresh(mesh=mesh))
            walls.append(ms)
            assert rec.configuration_id == reference_id, (label, rec.configuration_id)
            want = {name: 0 for name in launches}
            # one fd_phase_rows call a round covers every shard of the card
            # and splits the key, with loss or without
            want.update(fd_phase_rows=16, fd_gather=16)
            assert launches == want, (label, launches)
        sim = fresh(mesh=mesh)
        sim.crash(victims)
        syncs = _count_syncs(lambda: sim.run_until_decision(max_rounds=16, batch=16))
        assert syncs == 1, f"{label}: {syncs} synchronizing calls in one dispatch"
        sim = fresh(mesh=mesh)
        sim.crash(victims)
        prof = _profile(lambda: sim.run_until_decision(max_rounds=16, batch=16))
        # the dispatch alone (the 16 rounds, no upload, no view change): its
        # copies beyond the single-device scan dispatch's are the exchange's
        sim = fresh(mesh=mesh)
        sim.crash(victims)
        inputs = sim._const_inputs(None)
        sim.ready()
        dispatch = _profile(lambda: sim._sharded_run_until(False)(sim.state, inputs, 16))
        words = kernels.segment_words(N_NODES // size, 10)
        out[label] = {"walls_ms": walls, "launches": launches, "syncs": syncs, **prof,
                      "dispatch": dispatch, "exchange_bytes_per_round": size * words * 4,
                      "exchange_copies_per_round":
                          (dispatch["copies"] - scan_dispatch["copies"]) / 16,
                      "split_us_per_round": (dispatch["rows_us"] + dispatch["gather_us"]) / 16}
        print(f"sharded decision, {label} ({mesh}): {N_NODES} members, "
              f"{len(victims)} crashed, cut ok, {rec.membership_size} members, virtual "
              f"{rec.virtual_time_ms} ms, configuration id {rec.configuration_id} (the "
              f"single-device one), walls {[round(w, 3) for w in walls]} ms (the first "
              f"warms the mesh), syncs per dispatch {syncs}, launches "
              f"{ {k: v for k, v in launches.items() if v} }; profiled decision: GPU ops "
              f"{prof['kernels']} (and {prof['annotations']} named ranges), device busy "
              f"{prof['device_busy_ms']:.3f} ms, idle "
              f"{prof['idle_share']:.1%}, copies {prof['copies']} (uploads, the view "
              f"change's placement); the dispatch alone: GPU ops {dispatch['kernels']}, "
              f"copies a round {dispatch['copies'] / 16:g} ({dispatch['copy_us'] / 16:.2f} us) "
              f"against {scan_dispatch['copies'] / 16:g} in the single-device scan dispatch; "
              f"exchange {size * words * 4} B a round into home's bitset with "
              f"{(dispatch['copies'] - scan_dispatch['copies']) / 16:g} copies a round; "
              f"split device us a round: rows {dispatch['rows_us'] / 16:.2f}, gather "
              f"{dispatch['gather_us'] / 16:.2f}", flush=True)

    # the lossy decision on 8 shards: each device call splits the key and
    # draws, with no launch of its own for either
    mesh = shard.make_mesh(devices=[card] * 8)
    rec, ms, launches = decide(fresh(mesh=mesh), "ingress_loss")
    assert rec.configuration_id == reference_id, rec.configuration_id
    want = {name: 0 for name in launches}
    want.update(fd_phase_rows=16, fd_gather=16)
    assert launches == want, launches
    sim = fresh(mesh=mesh)
    sim.ingress_loss(victims, 1.0)
    prof = _profile(lambda: sim.run_until_decision(max_rounds=16, batch=16))
    out["8 shards, ingress loss 1.0"] = {"wall_ms": ms, "launches": launches, **prof}
    print(f"sharded decision, 8 shards, ingress loss 1.0: cut ok, virtual "
          f"{rec.virtual_time_ms} ms, configuration id {rec.configuration_id}, wall {ms:.3f} ms, "
          f"launches {({k: v for k, v in launches.items() if v})}; profiled decision: GPU ops "
          f"{prof['kernels']} (and {prof['annotations']} named ranges), device busy "
          f"{prof['device_busy_ms']:.3f} ms", flush=True)

    config = engine.SimConfig(capacity=N_NODES, fd_policy="windowed")
    mesh = shard.make_mesh(devices=[card] * 4)
    rec, ms, launches = decide(fresh(mesh=mesh, config=config))
    want = {name: 0 for name in launches}
    want.update(fd_phase_rows_windowed=16, fd_gather=16)
    assert launches == want, launches
    out["windowed 4 shards"] = {"wall_ms": ms, "launches": launches}
    print(f"sharded decision, windowed, 4 shards: cut ok, virtual {rec.virtual_time_ms} ms, "
          f"wall {ms:.3f} ms (first on this config), launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return out


_MULTIHOST_RECORD = re.compile(r"cut (\d+) nodes in (\d+) ms protocol time .*; config (-?\d+)")


def _multihost_children(processes, per_process, loss, seed, device="cuda", n=N_NODES):
    """``python -m rapid_tpu_torch.cli.multihost_sim`` in ``processes``
    child processes on this machine (gloo on localhost, each process's
    shards on ``device``), one warm-up decision each, every child under
    ``MULTIHOST_TIMEOUT_S`` and killed in ``finally``. The kernels are built
    before (the children load that build). Returns each rank's record (cut
    size, protocol ms, configuration id) and its stats line."""
    import tempfile

    port = _free_ports(1)[0]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for rank in range(processes):
                cmd = [sys.executable, "-m", "rapid_tpu_torch.cli.multihost_sim",
                       "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(processes),
                       "--process-id", str(rank), "--devices-per-host", str(per_process),
                       "--n", str(n), "--seed", str(seed), "--device", device]
                if loss:
                    cmd += ["--ingress-loss", str(loss)]
                log = open(os.path.join(tmp, f"{rank}.log"), "w")
                procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                               cwd=root, env=dict(os.environ,
                                                                  PYTHONUNBUFFERED="1")), log))
            deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
            rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p, _ in procs]
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        texts = [open(os.path.join(tmp, f"{rank}.log")).read() for rank in range(processes)]
    ranks = []
    for rank, (rc, text) in enumerate(zip(rcs, texts)):
        assert rc == 0, f"multihost rank {rank} exited {rc}:\n{text[-4000:]}"
        assert f"mesh {{'dcn': {processes}, 'ici': {per_process}}}" in text, text[-2000:]
        m = _MULTIHOST_RECORD.search(text)
        assert m, f"multihost rank {rank}: no record line:\n{text[-2000:]}"
        stats = json.loads(text.split("stats ", 1)[1].splitlines()[0])
        ranks.append({"record": [int(g) for g in m.groups()], **stats})
    return ranks


def multihost_phase(Simulator, shard, kernels, card):
    """The multi-process mesh on this one card (MULTIHOST_RUNS): ingress
    loss 1.0 over 2 processes of 2 shards and the crash over 4 of 1, at 100k
    members, every rank's record equal to an in-process
    single-controller mesh of the same shape on this card with the same
    seed; each rank's decision wall, launches, collectives, bytes and syncs
    by label beside the in-process wall."""
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for label, processes, per_process, loss in MULTIHOST_RUNS:
        t0 = time.perf_counter()
        ranks = _multihost_children(processes, per_process, loss, MULTIHOST_SEED)
        phase_s = time.perf_counter() - t0
        mesh = shard.make_mesh(shape=(processes, per_process),
                               devices=[dev] * (processes * per_process))
        victims = np.random.default_rng(MULTIHOST_SEED).choice(
            N_NODES, max(1, int(N_NODES * 0.01)), replace=False)
        walls, records = [], set()
        for _ in range(2):  # the first warms this mesh and fault in the process
            sim = Simulator(N_NODES, seed=MULTIHOST_SEED, mesh=mesh).ready()
            (sim.ingress_loss(victims, loss) if loss else sim.crash(victims))
            kernels.reset_launches()
            t1 = time.perf_counter()
            rec = sim.run_until_decision(max_rounds=64 if loss else 16, batch=16)
            sim.ready()
            walls.append((time.perf_counter() - t1) * 1000.0)
            launches = dict(kernels.LAUNCHES)
            assert rec is not None and set(rec.cut.tolist()) == set(victims.tolist())
            records.add((len(rec.cut), rec.virtual_time_ms, rec.configuration_id))
        assert len(records) == 1, records
        want = list(records.pop())
        for r in ranks:
            assert r["record"] == want, (label, r["process"], r["record"], want)
            assert r["launches"]["fd_phase_rows"] == r["launches"]["fd_gather"] == 16, r
            assert r["launches"]["threefry_draw"] == 0, r
            assert r["collectives"] == r["syncs"]["shard.exchange"] == 16, r
            assert r["syncs"]["sim.decision_words"] == 1, r
        out[label] = {"ranks": ranks, "inprocess_walls_ms": walls,
                      "inprocess_launches": launches, "record": want, "phase_s": phase_s}
        print(f"multihost {label}: {processes} processes of {per_process} shards on {dev} "
              f"(gloo), {N_NODES} members, {len(victims)} "
              f"{'behind ingress loss ' + str(loss) if loss else 'crashed'}; every rank's "
              f"record (cut {want[0]}, virtual {want[1]} ms, configuration id {want[2]}) == "
              f"the in-process ({processes}, {per_process}) mesh's; in-process walls "
              f"{[round(w, 3) for w in walls]} ms (the first warms it; {card}); "
              f"{phase_s:.1f} s with the children's start-up",
              flush=True)
        for r in ranks:
            print(f"multihost {label}, rank {r['process']} (shards {r['shards']}): decision "
                  f"wall {r['wall_ms']:.3f} ms (after one warm-up decision), launches "
                  f"fd_phase_rows {r['launches']['fd_phase_rows']}, fd_gather "
                  f"{r['launches']['fd_gather']}, threefry_draw "
                  f"{r['launches']['threefry_draw']}, collectives {r['collectives']} of "
                  f"{r['bytes_a_collective']} B each, syncs {r['syncs']}", flush=True)
    return out


def fault_replay_phase(kernels, jitwatch, device, card):
    """The port's own fault plane on the card: the bench's gray-detection
    dimension held to tests/golden/torch_gray.json, then a plan at 100k
    members (1% victims, half ``slow_node``, half a drop rule at probability
    1.0, the adaptive gray streak on) replayed through
    ``faults.replay_on_simulator``: the cut must be the victims, through
    ``fd_phase_fused``; the replay's host parts timed apart, beside
    ``endpoint_slots``, which the replay no longer builds."""
    from rapid_tpu_torch import faults
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig

    t0 = time.perf_counter()
    gray, misses = gray_golden_check(device)
    gray_s = time.perf_counter() - t0
    assert not misses, f"gray dimension differs from {GRAY_GOLDEN}: {misses[:5]}"
    print(f"fault replay, gray dimension: the bench's slow-node and flapping runs, static "
          f"against adaptive, equal tests/golden/torch_gray.json exactly (speedups "
          f"{ {k: v['speedup'] for k, v in gray.items()} }), {gray_s:.2f} s ({card})",
          flush=True)

    config = SimConfig(capacity=N_NODES, fd_gray_confirm=GRAY_CONFIRM)
    sim = Simulator(N_NODES, config=config, seed=REPLAY_SEED, device=device).ready()
    victims = sorted(np.random.default_rng(REPLAY_SEED).choice(
        N_NODES, N_NODES // 100, replace=False).tolist())
    t0 = time.perf_counter()
    slots = faults.endpoint_slots(sim)
    slots_ms = (time.perf_counter() - t0) * 1000.0
    by_slot = {s: ep for ep, s in slots.items()}
    plan = faults.FaultPlan(seed=REPLAY_SEED)
    half = len(victims) // 2
    for v in victims[:half]:
        plan.slow_node(by_slot[v], GRAY_DELAY_MS)
    for v in victims[half:]:
        plan.drop(1.0, dst=by_slot[v])
    t0 = time.perf_counter()
    faults.apply_plan_at(sim, plan, 0)  # the replay's own slot lookups
    apply_ms = (time.perf_counter() - t0) * 1000.0
    t0 = time.perf_counter()
    faults.apply_plan_at(sim, plan, 0, slots)
    apply_dict_ms = (time.perf_counter() - t0) * 1000.0
    sim.clear_link_faults()
    jitwatch.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    records = faults.replay_on_simulator(sim, plan, duration_ms=REPLAY_HORIZON_MS)
    sim.ready()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = dict(kernels.LAUNCHES)
    syncs = jitwatch.sync_counts()
    assert records and sorted(int(c) for c in records[0].cut) == victims, [
        len(r.cut) for r in records]
    assert launches["fd_phase_fused"] > 0, launches
    out = {"gray": gray, "gray_s": gray_s, "victims": len(victims),
           "records": [_record_digest(r) | {"cut": len(r.cut)} for r in records],
           "wall_ms": wall_ms, "endpoint_slots_ms": slots_ms, "apply_plan_at_ms": apply_ms,
           "apply_plan_at_given_slots_ms": apply_dict_ms,
           "launches": launches, "syncs": syncs}
    print(f"fault replay, {N_NODES} members: {half} slow_node + {len(victims) - half} drop "
          f"1.0 victims, fd_gray_confirm {GRAY_CONFIRM}, {REPLAY_HORIZON_MS} ms horizon: cut "
          f"== the victims at virtual {records[0].virtual_time_ms} ms, {len(records)} "
          f"record(s); replay wall {wall_ms:.3f} ms; host parts timed apart before it: "
          f"apply_plan_at {apply_ms:.3f} ms with the replay's own slot lookups (which the "
          f"replay repeats), {apply_dict_ms:.3f} ms given endpoint_slots, which took "
          f"{slots_ms:.3f} ms to build (the replay does not); launches "
          f"{ {k: v for k, v in launches.items() if v} }, syncs {syncs} ({card})", flush=True)
    return out


class ScriptNetwork:
    """The smallest network the bridge runs on: the bridge as the one
    multi-endpoint handler, scripted members by address, and a queue that
    ``scheduler.run_for`` drains, with what each delivery sends in turn.
    ``dst=None`` is the wildcard broadcast (``handle_broadcast``)."""

    def __init__(self, protocol):
        self.protocol = protocol
        self.scheduler = self
        self.handlers = []
        self.members = {}
        self.queue = collections.deque()
        self.deliver_s = 0.0  # host time spent delivering

    def attach_handler(self, handler):
        self.handlers.append(handler)

    def is_listening(self, address):
        return address in self.members

    def deliver(self, src, dst, msg, timeout_ms):
        promise = self.protocol.Promise()
        self.queue.append((src, dst, msg, promise))
        return promise

    def run_for(self, ms):
        t0 = time.perf_counter()
        response = self.protocol.Response()
        while self.queue:
            src, dst, msg, promise = self.queue.popleft()
            if dst in self.members:
                self.members[dst].receive(src, msg)
                promise.set_result(response)
                continue
            (handler,) = self.handlers
            reply = handler.handle_broadcast(msg) if dst is None else handler.handle(dst, msg)
            reply.add_callback(lambda r, p=promise: p.set_exception(r.exception())
                               if r.exception() is not None else p.set_result(r.peek()))
        self.deliver_s += time.perf_counter() - t0


class ScriptedMember:
    """A real member scripted after ``Cluster``: the two-phase join (one
    JoinMessage per distinct expected observer, with its ring numbers), a
    fast-round vote for each announced proposal (alerts on all K rings,
    stamped with the configuration they were raised in), the view change
    applied from a decision's alert batch and vote batch, and a graceful
    leave. It keeps the member list it learns."""

    def __init__(self, network, endpoint, node_id, k):
        self.net, self.endpoint, self.node_id, self.k = network, endpoint, node_id, k
        self.p = network.protocol
        network.members[endpoint] = self
        self.view = None  # endpoints of the configuration, once admitted
        self.join_replies = []
        self.announcements, self.votes, self.decisions = [], [], []
        self.registered = []  # (slot, taken) of each vote the swarm registered
        self._decision_alerts = None

    def send(self, dst, msg):
        promise = self.net.deliver(self.endpoint, dst, msg, 5000)
        self.net.run_for(0)
        return promise

    def join(self, seed_endpoint):
        p = self.p
        reply = self.send(seed_endpoint, p.PreJoinMessage(self.endpoint, self.node_id)).result(60)
        assert reply.status_code == p.JoinStatusCode.SAFE_TO_JOIN, reply.status_code
        rings = {}
        for ring, observer in enumerate(reply.endpoints):
            rings.setdefault(observer, []).append(ring)
        for observer, numbers in rings.items():
            self.send(observer, p.JoinMessage(self.endpoint, self.node_id, tuple(numbers),
                                              reply.configuration_id)
                      ).add_callback(lambda r: self.join_replies.append(r.peek()))
        return len(rings)

    def admitted(self):
        """The join's one full configuration (the siblings answer
        CONFIG_CHANGED), adopted as the member list."""
        full = [r for r in self.join_replies if r.status_code == self.p.JoinStatusCode.SAFE_TO_JOIN]
        assert len(full) == 1 and all(
            r.status_code == self.p.JoinStatusCode.CONFIG_CHANGED
            for r in self.join_replies if r is not full[0]), self.join_replies
        self.view = set(full[0].endpoints)
        assert len(self.view) == len(full[0].endpoints)
        return full[0]

    def leave(self):
        self.send(None, self.p.LeaveMessage(self.endpoint))

    def receive(self, src, msg):
        from rapid_tpu_torch.hashing import address_comparator_key

        p = self.p
        if isinstance(msg, p.BatchedAlertMessage):
            if all(len(a.ring_numbers) == self.k for a in msg.messages):
                # an announced proposal: vote for its cut
                cut = tuple(sorted((a.edge_dst for a in msg.messages), key=address_comparator_key))
                self.announcements.append(msg)
                vote = p.FastRoundPhase2bMessage(self.endpoint, msg.messages[0].configuration_id,
                                                 cut)
                self.votes.append(vote)
                self.net.deliver(self.endpoint, None, vote, 5000)
            else:
                self._decision_alerts = msg
        elif isinstance(msg, p.FastRoundVoteBatch):
            alerts = self._decision_alerts.messages
            assert {a.edge_dst for a in alerts} == set(msg.endpoints), "alerts != voted cut"
            quorum = len(self.view) - (len(self.view) - 1) // 4
            assert len(set(msg.senders)) >= quorum, (len(msg.senders), quorum)
            self.decisions.append((self._decision_alerts, msg, quorum))
            for a in alerts:
                (self.view.add if a.edge_status == p.EdgeStatus.UP else self.view.discard)(
                    a.edge_dst)
            if self.endpoint not in self.view:
                del self.net.members[self.endpoint]  # removed: the member shuts down


def bridge_sequence(n, device, mesh_devices, seed=SEED):
    """The bridge phase: ``TpuSimMessaging(ScriptNetwork, n)`` on the port's
    default protocol, ``warm_compile`` timed, then a scripted member's join,
    a crash of 1% of the virtual members (the closed form, this pump inside
    a ``jitwatch`` timed window), a crash of 1% more under ingress loss 1.0
    (the scan), its leave, and the join and first crash again on a bridge
    over ``make_mesh(devices=mesh_devices)``. Each pump's wall is split into
    the simulator's dispatches, delivery and the bridge's host work, with its
    syncs by label and kernel launches. After each decision the swarm's
    configuration id must equal that of a plain ``Simulator`` driven through
    the same identity, joins, crashes and leave with no bridge, and the
    member's list the swarm's members."""
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.shard.engine import make_mesh
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.bridge import TpuSimMessaging, default_protocol
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig

    protocol = default_protocol()
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 10_000)
    victims = [np.sort(v) for v in np.split(rng.choice(n, 2 * (n // 100), replace=False), 2)]
    node_id = protocol.NodeId(0x1234_5678_9ABC, -0x0FED_CBA9_8765)
    member_ep = protocol.Endpoint.from_parts("10.77.0.1", 7000)
    pumps = []

    def new_bridge(mesh=None):
        net = ScriptNetwork(protocol)
        bridge = TpuSimMessaging(net, n, seed=seed, mesh=mesh,
                                 device=None if mesh is not None else device)
        member = ScriptedMember(net, member_ep, node_id, bridge.sim.config.k)
        sim = bridge.sim
        timers = [0.0, 0.0]  # the simulator's dispatches, the full configuration's build
        run, register = sim.run_until_decision, sim.register_extern_vote
        full_config = bridge._full_config_response

        def timed(fn, i):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    timers[i] += time.perf_counter() - t0
            return call

        def counted_register(slot, cut):
            ok = register(slot, cut)
            member.registered.append((slot, ok))
            return ok

        sim.run_until_decision, sim.register_extern_vote = timed(run, 0), counted_register
        bridge._full_config_response = timed(full_config, 1)
        return net, bridge, member, timers

    def pump(name, net, bridge, member, timers, window=False):
        sim = bridge.sim
        n_before = sim.membership_size
        kernels.reset_launches()
        before, timers[:], net.deliver_s = jitwatch.sync_counts(), [0.0, 0.0], 0.0
        out = []
        t0 = time.perf_counter()
        if window:
            with jitwatch.timed_window(f"bridged pump, {name}"):
                out.append(bridge.pump())
            counted = None
        elif on_card:
            counted = _count_syncs(bridge.pump, out)
        else:
            out.append(bridge.pump())
            counted = None
        pump_s = time.perf_counter() - t0
        in_pump_delivery = net.deliver_s
        net.run_for(0)  # the decision's packets to the member
        rec = out[0]
        assert rec is not None, f"bridged {name}: no decision"
        row = {"name": name, "wall_ms": (pump_s + net.deliver_s - in_pump_delivery) * 1e3,
               "dispatch_ms": timers[0] * 1e3, "delivery_ms": net.deliver_s * 1e3,
               "host_ms": (pump_s - timers[0] - in_pump_delivery) * 1e3,
               "full_configuration_ms": timers[1] * 1e3,
               "syncs": _diff(jitwatch.sync_counts(), before), "counted_syncs": counted,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "cut": rec.cut.tolist(), "members_before": n_before,
               "configuration_id": rec.configuration_id,
               "virtual_time_ms": rec.virtual_time_ms}
        if member.view is not None:
            assert member.view == {bridge.endpoint(int(s)) for s in sim.members()}, name
        pumps.append(row)
        return rec, row

    def expect_vote_and_decision(name, bridge, member, cut_slots, n_before):
        """The member got the announced proposal, voted it, the bridge took
        the vote, and the decision reached it as one alert batch and one vote
        batch naming exactly the cut, with at least the quorum of senders."""
        slot = bridge._slot_of[member_ep]
        cut = {bridge.endpoint(int(s)) for s in cut_slots}
        assert len(member.announcements) == 1 and len(member.votes) == 1, name
        assert set(member.votes[0].endpoints) == cut, name
        assert member.registered == [(slot, True)], (name, member.registered)
        assert len(member.decisions) == 1, name
        alerts, votes, quorum = member.decisions[0]
        assert {a.edge_dst for a in alerts.messages} == set(votes.endpoints) == cut, name
        assert quorum == n_before - (n_before - 1) // 4 and len(votes.senders) >= quorum, name
        member.announcements, member.votes, member.decisions, member.registered = [], [], [], []
        return {"vote_registered": True, "alert_batch": len(alerts.messages),
                "vote_senders": len(votes.senders), "quorum": quorum}

    net, bridge, member, timers = new_bridge()
    sim = bridge.sim
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    bridge.warm_compile()
    warm_ms = (time.perf_counter() - t0) * 1e3
    twin_bytes = (torch.cuda.max_memory_allocated() - resident) if on_card else None

    observers = member.join(bridge.endpoint(0))
    rec, row = pump("join", net, bridge, member, timers)
    full = member.admitted()
    assert rec.added.tolist() == [bridge._slot_of[member_ep]] and len(full.endpoints) == n + 1
    assert full.configuration_id == sim.configuration_id() == rec.configuration_id
    row.update(full_configuration=len(full.endpoints), distinct_observers=observers)
    assert row["full_configuration_ms"] > 0

    sim.crash(victims[0])
    rec, row = pump("crash, closed form", net, bridge, member, timers, window=True)
    assert rec.cut.tolist() == victims[0].tolist()
    row.update(expect_vote_and_decision(row["name"], bridge, member, victims[0], n + 1))

    sim.crash(victims[1])
    sim.ingress_loss(victims[1], 1.0)
    rec, row = pump("crash, scan", net, bridge, member, timers)
    assert rec.cut.tolist() == victims[1].tolist()
    row.update(expect_vote_and_decision(row["name"], bridge, member, victims[1],
                                        n + 1 - len(victims[0])))
    if on_card:
        assert row["launches"].get("fd_phase_fused", 0) > 0, row["launches"]

    before = rec.virtual_time_ms
    slot = bridge._slot_of[member_ep]
    member.leave()
    rec, row = pump("leave", net, bridge, member, timers)
    assert rec.cut.tolist() == [slot] and member_ep not in net.members
    assert member_ep not in bridge._real and slot in bridge._free_slots
    row["decided_in_ms"] = rec.virtual_time_ms - before
    assert row["decided_in_ms"] == 2 * sim.config.fd_interval_ms + sim.config.batching_window_ms

    del net, bridge, member, sim
    mesh = make_mesh(devices=mesh_devices)
    net, bridge, member, timers = new_bridge(mesh)
    member.join(bridge.endpoint(0))
    pump("mesh join", net, bridge, member, timers)
    member.admitted()
    bridge.sim.crash(victims[0])
    rec, row = pump("mesh crash", net, bridge, member, timers)
    row.update(expect_vote_and_decision(row["name"], bridge, member, victims[0], n + 1))
    if on_card:
        assert row["launches"].get("fd_phase_rows", 0) > 0, row["launches"]
        assert row["launches"].get("fd_gather", 0) > 0, row["launches"]
    del net, bridge, member

    # the cross-check: a plain simulator driven alike, with no bridge
    capacity = -(-(n + 16) // mesh.size) * mesh.size
    plain = Simulator(n, capacity=capacity, config=SimConfig(capacity=capacity, extern_proposals=4),
                      seed=seed, device=device)
    plain.assign_identity(n, member_ep.hostname, member_ep.port, node_id.high, node_id.low)
    steps = (lambda: plain.request_joins(np.array([n])),
             lambda: plain.crash(victims[0]),
             lambda: (plain.crash(victims[1]), plain.ingress_loss(victims[1], 1.0)),
             lambda: plain.leave(np.array([n])))
    ids = []
    for step in steps:
        step()
        prec = plain.run_until_decision(max_rounds=32, batch=8)
        assert prec is not None
        ids.append(prec.configuration_id)
    for row, want in zip(pumps, ids + ids[:2]):
        row["plain_configuration_id"] = want
        assert row["configuration_id"] == want, (row["name"], row["configuration_id"], want)
    for row in pumps:
        print(f"bridged pump, {row['name']}: {row['members_before']} members, cut "
              f"{len(row['cut'])}, configuration id {row['configuration_id']} (== the plain "
              f"simulator's), virtual {row['virtual_time_ms']} ms; wall {row['wall_ms']:.3f} ms "
              f"= dispatch {row['dispatch_ms']:.3f} + bridge host {row['host_ms']:.3f} + "
              f"delivery {row['delivery_ms']:.3f}; syncs by label {row['syncs']}"
              + ("" if row["counted_syncs"] is None else
                 f" (debug mode counted {row['counted_syncs']})")
              + f"; kernel launches {row['launches']}"
              + "".join(f"; {k} {row[k]}" for k in (
                  "full_configuration", "full_configuration_ms", "distinct_observers",
                  "vote_registered", "alert_batch",
                  "vote_senders", "quorum", "decided_in_ms") if row.get(k)), flush=True)
    steady = [row["wall_ms"] for row in pumps[1:4]]
    print(f"bridge warm_compile: {warm_ms:.3f} ms"
          + ("" if twin_bytes is None else f" (peak {twin_bytes / 2**20:.1f} MiB above the "
             "swarm's own state: the twin simulator and its decisions)")
          + f"; first pump after it {pumps[0]['wall_ms']:.3f} ms, median of the next three "
          f"{statistics.median(steady):.3f} ms", flush=True)
    return {"protocol": protocol.Endpoint.__module__, "warm_compile_ms": warm_ms,
            "twin_peak_bytes": twin_bytes, "first_pump_ms": pumps[0]["wall_ms"],
            "steady_median_ms": statistics.median(steady), "pumps": pumps}



def view_configuration_id(endpoints, identifiers) -> int:
    """The configuration id a member computes from its own view
    (MembershipView.java:535-547): identifiers in NodeId order, endpoints in
    ring-0 order, with the port's vectorized hashing."""
    from rapid_tpu_torch.hashing import endpoint_hash_batch
    from rapid_tpu_torch.sim.topology import configuration_id_vectorized

    eps = list(endpoints)
    width = max(len(e.hostname) for e in eps)
    hosts = np.frombuffer(b"".join(e.hostname.ljust(width, b"\0") for e in eps),
                          dtype=np.uint8).reshape(len(eps), width)
    lengths = np.array([len(e.hostname) for e in eps], dtype=np.int64)
    ports = np.array([e.port for e in eps], dtype=np.int64)
    order = np.argsort(endpoint_hash_batch(hosts, lengths, ports, 0).view(np.int64),
                       kind="stable")
    ids = sorted(identifiers)
    return configuration_id_vectorized(
        np.array([i.high for i in ids], dtype=np.int64),
        np.array([i.low for i in ids], dtype=np.int64), hosts[order], lengths[order],
        ports[order])


class GatewayMemberNet:
    """``ScriptedMember``'s network over the port's wire: sends ride the
    member's ``GatewayRoutedClient`` to the gateway, a broadcast (``dst``
    None) its ``GatewaySwarmBroadcaster``'s one wildcard frame."""

    def __init__(self, protocol, routed, broadcaster):
        self.protocol, self.routed, self.broadcaster = protocol, routed, broadcaster
        self.members = {}

    def deliver(self, src, dst, msg, timeout_ms):
        if dst is None:
            (promise,) = self.broadcaster.broadcast(msg)
            return promise
        return self.routed.send_message(dst, msg)

    def run_for(self, ms):
        pass  # the sockets run on their own threads


def gateway_member(gateway_address: str, port: int) -> int:
    """``chip_smoke.py --gateway-member <host:port> <port>``: a real member
    in its own OS process that speaks only through the port's wire. Its
    ``TcpClientServer`` listens at 127.0.0.1:<port> with ``ScriptedMember``
    as its membership service; a ``GatewayRoutedClient`` and a
    ``GatewaySwarmBroadcaster`` carry its sends. It reads commands on its
    standard input (``join <seed> <k>``, ``leave``, ``quit``) and prints one
    JSON line per event it sees, each with its wall-clock time ``t``: its
    configuration id is computed from its own view."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapid_tpu_torch.messaging import codec, gateway, tcp
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.sim.bridge import default_protocol

    protocol = default_protocol()
    settings = Settings(**GATEWAY_SETTINGS)
    lock = threading.Lock()
    decoded = {"ms": 0.0, "bytes": 0, "largest": 0, "largest_ms": 0.0, "large": []}

    def emit(event, t=None, **fields):
        """One event line; ``t`` is when it happened (default: now)."""
        with lock:
            print(json.dumps(dict(event=event, t=time.time() if t is None else t, **fields),
                             default=str), flush=True)

    def timed_decode(frame):
        t0 = time.perf_counter()
        out = codec.decode(frame)
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
            decoded["ms"] += ms
            decoded["bytes"] += len(frame)
            if len(frame) > decoded["largest"]:
                decoded["largest"], decoded["largest_ms"] = len(frame), ms
            if len(frame) >= LARGE_FRAME:
                decoded["large"].append((type(out[1]).__name__, len(frame), round(ms, 3)))
        return out

    tcp.decode = timed_decode  # every frame this process reads

    def decode_stats():
        """What this process decoded since the last event that reported it."""
        with lock:
            out = {"decoded_ms": decoded["ms"], "decoded_bytes": decoded["bytes"],
                   "largest_frame": decoded["largest"], "largest_decode_ms": decoded["largest_ms"],
                   "large_decodes": decoded["large"]}
            decoded.update(ms=0.0, bytes=0, largest=0, largest_ms=0.0, large=[])
        return out

    me = protocol.Endpoint.from_parts("127.0.0.1", port)
    transport = tcp.TcpClientServer(me, settings)
    routed = gateway.GatewayRoutedClient(me, protocol.Endpoint.from_string(gateway_address),
                                         transport, settings)
    broadcaster = gateway.GatewaySwarmBroadcaster(routed)
    net = GatewayMemberNet(protocol, routed, broadcaster)
    member = ScriptedMember(net, me, protocol.NodeId(*MEMBER_NODE_ID), 0)
    state = {"identifiers": set()}

    def view_fields():
        return {"members": len(member.view),
                "configuration_id": view_configuration_id(member.view, state["identifiers"])}

    class Service:
        def handle_message(self, msg):
            counts = (len(member.announcements), len(member.decisions))
            member.receive(None, msg)
            seen = time.time()
            if len(member.announcements) > counts[0]:
                emit("announcement", alerts=len(msg.messages),
                     configuration_id=msg.messages[0].configuration_id)
                emit("vote", cut=len(member.votes[-1].endpoints))
            if len(member.decisions) > counts[1]:
                alerts, votes, quorum = member.decisions[-1]
                for a in alerts.messages:
                    if a.edge_status == protocol.EdgeStatus.UP and a.node_id is not None:
                        state["identifiers"].add(a.node_id)
                removed = me not in member.view
                emit("removed" if removed else "decision", t=seen, alerts=len(alerts.messages),
                     vote_senders=len(set(votes.senders)), quorum=quorum,
                     **({} if removed else view_fields()), **decode_stats())
            return protocol.Promise.completed(protocol.Response())

    transport.set_membership_service(Service())
    transport.start()
    broadcaster.set_membership([protocol.Endpoint(b"10.0.0.0", 0)])  # the swarm is a peer
    emit("ready", endpoint=str(me))
    try:
        for line in sys.stdin:
            cmd = line.split()
            if not cmd:
                continue
            if cmd[0] == "join":
                member.k = int(cmd[2])
                t0 = time.time()
                observers = member.join(protocol.Endpoint.from_string(cmd[1]))
                deadline = time.time() + GATEWAY_WAIT_S
                while len(member.join_replies) < observers and time.time() < deadline:
                    time.sleep(0.005)
                full = member.admitted()
                admitted = time.time()
                state["identifiers"] = set(full.identifiers)
                broadcaster.set_membership(sorted(member.view - {me}))
                emit("joined", t=admitted, started=t0, observers=observers, endpoints=len(full.endpoints),
                     response_configuration_id=full.configuration_id, **view_fields(),
                     **decode_stats())
            elif cmd[0] == "leave":
                member.leave()
                emit("leave_sent")
            elif cmd[0] == "quit":
                break
    finally:
        routed.shutdown()
        transport.shutdown()
    return 0


def _free_ports(k):
    """``k`` ports free on 127.0.0.1 just now."""
    socks = []
    try:
        for _ in range(k):
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            socks.append(sock)
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


class _ChildMember:
    """The parent's handle on the ``--gateway-member`` process: commands on
    its standard input, its JSON events read off its standard output by a
    thread, every wait bounded."""

    def __init__(self, gateway_address, port):
        here = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--gateway-member",
             gateway_address, str(port)],
            cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self.events = queue.Queue()
        self.seen = []
        self.stderr = []
        threading.Thread(target=self._read, args=(self.proc.stdout, True), daemon=True).start()
        threading.Thread(target=self._read, args=(self.proc.stderr, False), daemon=True).start()

    def _read(self, stream, events):
        for line in stream:
            if events and line.startswith("{"):
                self.events.put(json.loads(line))
            else:
                self.stderr.append(line)

    def send(self, command):
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def wait(self, name, timeout=GATEWAY_WAIT_S):
        deadline = time.time() + timeout
        while True:
            try:
                event = self.events.get(timeout=max(0.01, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(
                    f"gateway member: no '{name}' event in {timeout} s; events so far "
                    f"{[e['event'] for e in self.seen]}; stderr tail "
                    f"{''.join(self.stderr[-20:])}") from None
            self.seen.append(event)
            if event["event"] == name:
                return event

    def close(self):
        try:
            if self.proc.poll() is None:
                self.send("quit")
                self.proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


class _CodecClock:
    """Encode and decode time, frames and bytes on every thread of this
    process, through the codec names that ``messaging/tcp.py`` and
    ``messaging/gateway.py`` call; the names are restored on exit."""

    def __init__(self):
        from rapid_tpu_torch.messaging import codec, gateway, tcp

        self._modules = (tcp, gateway)
        self._codec = codec
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.totals = {"encode_ms": 0.0, "encodes": 0, "encoded_bytes": 0,
                           "decode_ms": 0.0, "decodes": 0, "decoded_bytes": 0,
                           "largest_frame": 0, "largest_frame_encode_ms": 0.0,
                           "large_encodes": []}

    def snapshot(self):
        with self._lock:
            return dict(self.totals, large_encodes=list(self.totals["large_encodes"]))

    def _encode(self, request_no, msg):
        t0 = time.perf_counter()
        out = self._codec.encode(request_no, msg)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            t = self.totals
            t["encode_ms"] += ms
            t["encodes"] += 1
            t["encoded_bytes"] += len(out)
            if len(out) > t["largest_frame"]:
                t["largest_frame"], t["largest_frame_encode_ms"] = len(out), ms
            if len(out) >= LARGE_FRAME:
                t["large_encodes"].append((type(msg).__name__, len(out), round(ms, 3)))
        return out

    def _decode(self, frame):
        t0 = time.perf_counter()
        out = self._codec.decode(frame)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.totals["decode_ms"] += ms
            self.totals["decodes"] += 1
            self.totals["decoded_bytes"] += len(frame)
        return out

    def __enter__(self):
        for module in self._modules:
            module.encode, module.decode = self._encode, self._decode
        return self

    def __exit__(self, *exc):
        for module in self._modules:
            module.encode, module.decode = self._codec.encode, self._codec.decode


def _frame_config(msg):
    """The configuration id a protocol message is stamped with (an alert
    batch's: its first alert's), or None."""
    if getattr(msg, "messages", None):
        return msg.messages[0].configuration_id
    return getattr(msg, "configuration_id", None)


class _LoggedDict(dict):
    """A dict that logs its stores and pops (the bridge's ``_undelivered``)."""

    def __init__(self, log, name, items=()):
        super().__init__(items)
        self._log, self._name = log, name

    def __setitem__(self, key, value):
        self._log(f"{self._name} set", key, config=value)
        super().__setitem__(key, value)

    def pop(self, key, *default):
        if key in self:
            self._log(f"{self._name} pop", key)
        return super().pop(key, *default)


class _LoggedSet(set):
    """A set that logs its adds and discards (the bridge's ``_chain_inflight``)."""

    def __init__(self, log, name, items=()):
        super().__init__(items)
        self._log, self._name = log, name

    def add(self, item):
        self._log(f"{self._name} add", item)
        super().add(item)

    def discard(self, item):
        if item in self:
            self._log(f"{self._name} discard", item)
        super().discard(item)


class _RedriveLog:
    """The bridge's repair paths behind a gateway, logged for a failure
    message (newest last, bounded): the swarm's decisions, every decision
    chain started and by whom (``pump``, a catch-up replay
    ``_maybe_catch_up``, ``_reconcile_lagging``, or a chain's walk forward
    ``settle``), the transitions of ``_undelivered`` and
    ``_chain_inflight``, a real member's traffic stamped with a configuration
    the bridge still holds a packet or a record of, and every failed send
    attempt of the gateway's outbound client to a real member (a delivery
    retry follows each, within the 5 s deadline)."""

    def __init__(self, gateway, size=400):
        bridge = gateway.bridge
        # appended from the protocol, writer and callback threads: a deque's
        # append is atomic
        self.events = collections.deque(maxlen=size)  # guarded-by: atomic-append
        self._t0 = time.time()
        chain, catch_up = bridge._deliver_decision_chain, bridge._maybe_catch_up  # noqa: SLF001
        send_once = gateway._out._send_once  # noqa: SLF001

        def logged_chain(member, packet=None):
            p = packet if packet is not None else bridge._decision_packet  # noqa: SLF001
            self.add("chain", member, by=sys._getframe(1).f_code.co_name,  # noqa: SLF001
                     config=p and p[0], after=p and p[4])
            return chain(member, packet)

        def logged_catch_up(sender, config_id):
            if sender in bridge._real and (config_id in bridge._packet_history  # noqa: SLF001
                                           or config_id in bridge._prior_configs):  # noqa: SLF001
                self.add("stale traffic", sender, config=config_id,
                         replays=bridge._replay_counts.get(sender, 0))  # noqa: SLF001
            return catch_up(sender, config_id)

        def logged_send(remote, msg, timeout_ms=None):
            out = send_once(remote, msg, timeout_ms)
            if remote in bridge._real:  # noqa: SLF001
                out.add_callback(lambda p: p.exception() is None or self.add(
                    "send failed", remote, msg=type(msg).__name__, config=_frame_config(msg),
                    error=str(p.exception())))
            return out

        bridge._deliver_decision_chain = logged_chain  # noqa: SLF001
        bridge._maybe_catch_up = logged_catch_up  # noqa: SLF001
        gateway._out._send_once = logged_send  # noqa: SLF001
        bridge._undelivered = _LoggedDict(self.add, "undelivered", bridge._undelivered)  # noqa: SLF001
        bridge._chain_inflight = _LoggedSet(self.add, "inflight",  # noqa: SLF001
                                            bridge._chain_inflight)  # noqa: SLF001

    def add(self, kind, who, **fields):
        self.events.append((round(time.time() - self._t0, 3), threading.current_thread().name,
                            kind, str(who), fields))

    def tail(self, k=80):
        return list(self.events)[-k:]


class _GatewayProbe:
    """A ``SwarmGateway`` instrumented for a phase: the simulator's dispatches
    and the bridge's phase-B vote window timed, each pump that did device
    work recorded (its wall, its split, its syncs by ``jitwatch`` label and
    its kernel launches), the votes the swarm registered, and every protocol
    task's syncs by label and, on a card, under torch's sync debug mode
    "warn" (both counts cover the same tasks, whichever step a task
    straddles). ``reset`` starts a step; ``take`` reads it."""

    def __init__(self, gateway, on_card):
        from rapid_tpu_torch.runtime import jitwatch
        from rapid_tpu_torch.sim import kernels

        sim, bridge = gateway.bridge.sim, gateway.bridge
        self.redrives = _RedriveLog(gateway)
        self.lock = threading.Lock()
        self.pumps, self.registered, self.window_marks = [], [], []
        self.task_syncs, self.task_labels = 0, {}
        timers = {"dispatch": 0.0, "window": 0.0}
        run, register, pump = sim.run_until_decision, sim.register_extern_vote, bridge.pump
        window = gateway.network.scheduler.run_for
        run_task = gateway._run_task  # noqa: SLF001

        def timed(fn, key):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    timers[key] += time.perf_counter() - t0
            return call

        def marked_window(ms):
            start = time.time()
            try:
                return window(ms)
            finally:
                self.window_marks.append((start, time.time()))

        def counted_register(slot, cut):
            ok = register(slot, cut)
            with self.lock:
                self.registered.append((slot, ok))
            return ok

        def recorded_pump(*args, **kw):
            timers["dispatch"] = timers["window"] = 0.0
            syncs, launches = jitwatch.sync_counts(), dict(kernels.LAUNCHES)
            t0, start = time.perf_counter(), time.time()
            rec = pump(*args, **kw)
            wall = time.perf_counter() - t0
            if rec is not None:
                self.redrives.add("decision", "swarm", config=rec.configuration_id,
                                  cut=len(rec.cut))
            if rec is not None or timers["dispatch"] > 0:
                with self.lock:
                    self.pumps.append({
                        "start": start, "wall_ms": wall * 1e3, "rec": rec,
                        "dispatch_ms": timers["dispatch"] * 1e3,
                        "vote_window_ms": timers["window"] * 1e3,
                        "syncs": _diff(jitwatch.sync_counts(), syncs),
                        "launches": {k: v - launches.get(k, 0) for k, v in kernels.LAUNCHES.items()
                                     if v - launches.get(k, 0)}})
            return rec

        def counted_task(fn, label):
            before = jitwatch.sync_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if on_card:
                    previous = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    return run_task(fn, label)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(previous)
                    with self.lock:
                        self.task_syncs += sum("synchronizing CUDA operation" in str(w.message)
                                               for w in caught)
                        for key, n in _diff(jitwatch.sync_counts(), before).items():
                            self.task_labels[key] = self.task_labels.get(key, 0) + n

        sim.run_until_decision = timed(run, "dispatch")
        sim.register_extern_vote = counted_register
        bridge.pump = recorded_pump
        gateway.network.scheduler.run_for = timed(marked_window, "window")
        gateway._run_task = counted_task  # noqa: SLF001

    def reset(self):
        with self.lock:
            del self.pumps[:]
            del self.registered[:]
            self.task_syncs = 0
            self.task_labels.clear()

    def decided(self):
        with self.lock:
            return [p for p in self.pumps if p["rec"] is not None]

    def wait_decision(self, name):
        """The one pump of this step that decided, waited for."""
        deadline = time.time() + GATEWAY_WAIT_S
        while time.time() < deadline:
            decided = self.decided()
            if decided:
                break
            time.sleep(0.01)
        assert len(decided) == 1, (name, len(decided))
        return decided[0]

    def take(self):
        """(the step's pumps with work, registered votes, syncs by label,
        debug-mode count)."""
        with self.lock:
            return (list(self.pumps), list(self.registered), dict(self.task_labels),
                    self.task_syncs)


def gateway_sequence(n, device, seed=SEED, native_server=False, member_port=None):
    """The gateway phase: the port's ``SwarmGateway`` on 127.0.0.1 hosting
    ``n`` virtual members (seed ``seed``, ``GATEWAY_SETTINGS``), warmed,
    and a real member in a child OS process (``--gateway-member``) that
    joins over TCP (one full configuration of n + 1 endpoints), votes in a
    crash of 1% of the virtual members (the closed form) and in one of 1%
    more under ingress loss 1.0 (the scan), and leaves. The crashes run as
    tasks on the gateway's protocol thread. Each step: the wall as the
    member sees it, each decision pump's wall split into the simulator's
    dispatches, the phase-B vote window and the bridge's host work, the
    codec's encode and decode across the process, the largest frame, syncs
    by ``jitwatch`` label (on a card also counted by torch's sync debug
    mode on the protocol thread) and kernel launches. Every configuration
    id must be equal on three sides: the gateway's, the member's own view,
    and a plain ``Simulator`` driven alike. ``native_server``: the gateway's
    front door on the C++ epoll reactor; ``member_port``: the member's port
    (an earlier run's, so that the two runs' ids compare)."""
    from rapid_tpu_torch.messaging.gateway import SwarmGateway
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.bridge import default_protocol
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig

    protocol = default_protocol()
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 20_000)
    victims = [np.sort(v) for v in np.split(rng.choice(n, 2 * (n // 100), replace=False), 2)]
    if member_port is None:
        gw_port, member_port = _free_ports(2)
    else:
        gw_port = next(p for p in _free_ports(2) if p != member_port)
    member_ep = protocol.Endpoint.from_parts("127.0.0.1", member_port)
    gateway = SwarmGateway(protocol.Endpoint.from_parts("127.0.0.1", gw_port), n_virtual=n,
                           seed=seed, settings=Settings(**GATEWAY_SETTINGS),
                           pump_interval_ms=GATEWAY_PUMP_MS, native_server=native_server,
                           device=device)
    bridge, sim = gateway.bridge, gateway.bridge.sim
    probe = _GatewayProbe(gateway, on_card)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() if on_card else 0
    child = None
    steps = []
    codec_timer = _CodecClock()
    try:
        with codec_timer:
            gateway.start()
            assert (gateway._reactor is not None) == native_server  # noqa: SLF001
            assert (gateway._framed is None) == native_server  # noqa: SLF001
            t0 = time.perf_counter()
            gateway.warm()
            warm_s = time.perf_counter() - t0
            warm_bytes = (torch.cuda.max_memory_allocated() - resident) if on_card else None
            child = _ChildMember(f"127.0.0.1:{gw_port}", member_port)
            child.wait("ready", timeout=120)

            def step(name, act, event, cut_slots):
                n_before = sim.membership_size
                probe.reset()
                codec_timer.reset()
                kernels.reset_launches()
                start = time.time()
                act()
                seen = child.wait(event)
                decision = probe.wait_decision(name)
                rec = decision["rec"]
                time.sleep(3 * GATEWAY_PUMP_MS / 1e3)  # the next pumps see nothing to do
                work, votes, syncs, counted = probe.take()
                assert sorted(rec.cut.tolist()) == sorted(int(s) for s in cut_slots), name
                row = {"name": name, "members_before": n_before, "cut": len(rec.cut),
                       "configuration_id": rec.configuration_id,
                       "virtual_time_ms": rec.virtual_time_ms,
                       "member_wall_ms": (seen["t"] - start) * 1e3,
                       "pumps_with_work": len(work),
                       "pump_wall_ms": decision["wall_ms"],
                       "dispatch_ms": decision["dispatch_ms"],
                       "vote_window_ms": decision["vote_window_ms"],
                       "host_ms": decision["wall_ms"] - decision["dispatch_ms"]
                       - decision["vote_window_ms"],
                       "codec": codec_timer.snapshot(),
                       "member_decode_ms": seen.get("decoded_ms"),
                       "member_largest_frame": seen.get("largest_frame"),
                       "member_largest_decode_ms": seen.get("largest_decode_ms"),
                       "member_large_decodes": seen.get("large_decodes"),
                       "pump_syncs": decision["syncs"],
                       "pump_launches": decision["launches"],
                       "syncs": syncs,
                       "counted_syncs": counted if on_card else None,
                       "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                       "registered": votes, "event": seen}
                steps.append(row)
                return row, seen

            slot = n  # the first spare slot seats the joiner
            row, seen = step("join", lambda: child.send(
                f"join {gateway.seed_endpoint()} {sim.config.k}"), "joined", [slot])
            assert seen["endpoints"] == n + 1 == seen["members"], seen
            assert seen["configuration_id"] == seen["response_configuration_id"] \
                == gateway.configuration_id() == row["configuration_id"], seen
            assert bridge._slot_of[member_ep] == slot and member_ep in bridge._real  # noqa: SLF001
            row["member_configuration_id"] = seen["configuration_id"]

            quorum_of = {}
            for name, fault, cut in (
                    ("crash, closed form", lambda v=victims[0]: sim.crash(v), victims[0]),
                    ("crash, scan", lambda v=victims[1]: (sim.crash(v), sim.ingress_loss(v, 1.0)),
                     victims[1])):
                n_before = sim.membership_size
                row, seen = step(name, lambda f=fault: _on_protocol_thread(gateway, f),
                                 "decision", cut)
                quorum = n_before - (n_before - 1) // 4
                quorum_of[name] = quorum
                assert row["registered"] == [(slot, True)], (
                    name, row["registered"], "vote window (start, end) s:", probe.window_marks,
                    "member events (name, t):", [(e["event"], e["t"]) for e in child.seen[-4:]])
                assert seen["alerts"] == len(cut) and seen["quorum"] == quorum, (name, seen)
                assert seen["vote_senders"] >= quorum, (name, seen)
                assert seen["configuration_id"] == gateway.configuration_id() \
                    == row["configuration_id"], (name, seen)
                assert seen["members"] == sim.membership_size, (name, seen)
                votes = [e for e in child.seen if e["event"] == "vote"]
                assert votes and votes[-1]["cut"] == len(cut), name
                row.update(vote_registered=True, alert_batch=seen["alerts"],
                           vote_senders=seen["vote_senders"], quorum=quorum,
                           member_configuration_id=seen["configuration_id"])
                if on_card and name == "crash, scan":
                    assert row["pump_launches"].get("fd_phase_fused", 0) > 0, row["pump_launches"]

            row, seen = step("leave", lambda: child.send("leave"), "removed", [slot])
            assert member_ep not in bridge._real  # noqa: SLF001
            row["member_removed"] = True
    finally:
        if child is not None:
            child.close()
        gateway.shutdown()
        for thread in gateway._threads:  # noqa: SLF001 -- a pump in flight ends first
            thread.join(timeout=GATEWAY_WAIT_S)
    if on_card:
        for row in steps:
            assert row["counted_syncs"] == sum(row["syncs"].values()), (
                row["name"], row["counted_syncs"], row["syncs"])

    # the cross-check: a plain simulator driven alike, with no gateway
    capacity = n + 16
    plain = Simulator(n, capacity=capacity,
                      config=SimConfig(capacity=capacity, extern_proposals=4), seed=seed,
                      device=device)
    plain.assign_identity(n, member_ep.hostname, member_ep.port, *MEMBER_NODE_ID)
    actions = (lambda: plain.request_joins(np.array([n])),
               lambda: plain.crash(victims[0]),
               lambda: (plain.crash(victims[1]), plain.ingress_loss(victims[1], 1.0)),
               lambda: plain.leave(np.array([n])))
    for row, act in zip(steps, actions):
        act()
        prec = plain.run_until_decision(max_rounds=32, batch=8)
        assert prec is not None
        row["plain_configuration_id"] = prec.configuration_id
        assert row["configuration_id"] == prec.configuration_id, (row["name"], prec)
    del gateway, bridge, sim
    return {"warm_s": warm_s, "warm_peak_bytes": warm_bytes, "steps": steps,
            "member_port": member_port, "native_server": native_server}


def _on_protocol_thread(gateway, fn, timeout=GATEWAY_WAIT_S):
    """Run ``fn`` as a task on the gateway's protocol thread, the one thread
    that touches the swarm, and wait for it."""
    done, error = threading.Event(), []

    def task():
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 -- re-raised on this thread
            error.append(exc)
        finally:
            done.set()

    gateway._put_task(task, gateway.PRIO_FRAME, "fault")  # noqa: SLF001
    assert done.wait(timeout), "protocol task did not run"
    if error:
        raise error[0]


def _print_gateway(result, card, label="gateway"):
    for row in result["steps"]:
        c = row["codec"]
        print(f"{label}, {row['name']} ({card}): {row['members_before']} members, cut "
              f"{row['cut']}, configuration id {row['configuration_id']} (== the member's own "
              f"view == the plain simulator's), virtual {row['virtual_time_ms']} ms; wall as "
              f"the member sees it {row['member_wall_ms']:.3f} ms; decision pump "
              f"{row['pump_wall_ms']:.3f} ms = dispatch {row['dispatch_ms']:.3f} + vote window "
              f"(the announcement answered, then 100 ms) {row['vote_window_ms']:.3f} + bridge "
              f"host {row['host_ms']:.3f}; codec in the "
              f"gateway process: encode {c['encode_ms']:.3f} ms over {c['encodes']} frames "
              f"({c['encoded_bytes']} B), decode {c['decode_ms']:.3f} ms over {c['decodes']} "
              f"frames ({c['decoded_bytes']} B); largest frame {c['largest_frame']} B "
              f"(encoded in {c['largest_frame_encode_ms']:.3f} ms); member decode "
              f"{row['member_decode_ms']:.3f} ms, largest frame {row['member_largest_frame']} B "
              f"in {row['member_largest_decode_ms']:.3f} ms; frames of 64 KiB and more, "
              f"(class, bytes, ms): encoded {c['large_encodes']}, decoded by the member "
              f"{row['member_large_decodes']}; the decision pump's syncs by label "
              f"{row['pump_syncs']} and kernel launches {row['pump_launches']}; the step's "
              f"{row['pumps_with_work']} pumps with device work and every other protocol task: "
              f"syncs by label {row['syncs']}"
              + ("" if row["counted_syncs"] is None else
                 f" (debug mode counted {row['counted_syncs']})")
              + f", kernel launches {row['launches']}"
              + "".join(f"; {k} {row[k]}" for k in (
                  "vote_registered", "alert_batch", "vote_senders", "quorum") if row.get(k)),
              flush=True)
    print(f"{label} warm(): {result['warm_s']:.3f} s"
          + ("" if result["warm_peak_bytes"] is None else
             f", peak {result['warm_peak_bytes'] / 2**20:.1f} MiB of device memory above the "
             "swarm's own state") + f" ({card})", flush=True)


PORT_MEMBERS = 2  # real port members of member_sequence's second bridge
MEMBER_RNG_SEED = 7_000  # member i's builder rng is random.Random(MEMBER_RNG_SEED + i)
AGENT_JOIN_TIMEOUT_S = 300.0


class SwarmBroadcaster:
    """A real member's broadcaster on the bridge's in-process network, as
    ``GatewaySwarmBroadcaster`` is behind a gateway: one copy to the swarm
    through ``TpuSimMessaging.handle_broadcast`` (the bridge ingests alert
    batches and votes once a sender, so the copies to each virtual member
    of unicast-to-all are redundant; ``ScriptedMember`` broadcasts the same
    way) and the reference's best-effort unicast to every real member, the
    sender included."""

    def __init__(self, client, network, bridge):
        self._client, self._network, self._bridge = client, network, bridge
        self._real, self._any_swarm = [], False

    def set_membership(self, recipients):
        self._real = [r for r in recipients if self._network.is_listening(r)]
        self._any_swarm = len(self._real) < len(recipients)

    def broadcast(self, msg):
        promises = [self._client.send_message_best_effort(r, msg) for r in self._real]
        if self._any_swarm:
            out = self._bridge.protocol.Promise()

            def deliver():
                reply = self._bridge.handle_broadcast(msg)
                reply.add_callback(lambda p: out.try_set_result(p.peek())
                                   if p.exception() is None else
                                   out.try_set_exception(p.exception()))

            self._network.scheduler.schedule(0, deliver)
            promises.append(out)
        return promises


# the join's view and service build by phase (``_MemberClock.split``): the
# self time of each method, nested calls subtracted from their callers
BUILD_PHASES = (
    ("bulk_insert", "membership", "MembershipView", "_bulk_insert"),  # ring hashes, sorts, caches
    ("identifier_insort", "membership", "MembershipView", "__init__"),  # the view's own loop
    ("configuration_id", "membership", "MembershipView", "get_configuration"),  # scalar id
    ("service", "service", "MembershipService", "__init__"),
)


class _MemberClock:
    """Host time of the port's real members in this process: every protocol
    task of theirs (message handlers, the alert batcher, view changes: each
    runs through ``SharedResources.protocol_executor`` on the shared virtual
    scheduler) and their join's view and service build
    (``cluster.MembershipView`` and ``cluster.MembershipService``, timed
    apart as ``build_ms``). Nested calls count once. ``split`` holds the
    self time of each of ``BUILD_PHASES`` (whoever calls them), so the
    join's build reads by phase. The names are restored on exit."""

    def __init__(self):
        import importlib

        from rapid_tpu_torch import cluster
        from rapid_tpu_torch.runtime import resources

        self._cluster, self._executor = cluster, resources._SchedulerExecutor  # noqa: SLF001
        self._saved = (cluster.MembershipView, cluster.MembershipService,
                       self._executor.execute)
        self._methods = [
            (label, cls, attr, getattr(cls, attr)) for label, cls, attr in (
                (label, getattr(importlib.import_module(f"rapid_tpu_torch.{module}"), owner),
                 attr) for label, module, owner, attr in BUILD_PHASES)]
        self._depth = 0
        self._stack = []  # [label, start, time of nested phases]
        self.reset()

    def reset(self):
        self.ms = self.build_ms = 0.0
        self.split = {label: 0.0 for label, *_ in BUILD_PHASES}

    def _phase(self, label, fn):
        def call(*args, **kw):
            self._stack.append([label, time.perf_counter(), 0.0])
            try:
                return fn(*args, **kw)
            finally:
                _, t0, nested = self._stack.pop()
                ms = (time.perf_counter() - t0) * 1e3
                self.split[label] += ms - nested
                if self._stack:
                    self._stack[-1][2] += ms
        return call

    def _timed(self, fn, build):
        def call(*args, **kw):
            if self._depth:
                return fn(*args, **kw)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                self._depth -= 1
                self.ms += ms
                if build:
                    self.build_ms += ms
        return call

    def __enter__(self):
        view, service, execute = self._saved
        self._cluster.MembershipView = self._timed(view, True)
        self._cluster.MembershipService = self._timed(service, True)
        clock = self

        def timed_execute(executor, fn):
            execute(executor, clock._timed(fn, False))

        self._executor.execute = timed_execute
        for label, cls, attr, fn in self._methods:
            setattr(cls, attr, self._phase(label, fn))
        return self

    def __exit__(self, *exc):
        (self._cluster.MembershipView, self._cluster.MembershipService,
         self._executor.execute) = self._saved
        for _, cls, attr, fn in self._methods:
            setattr(cls, attr, fn)


def member_sequence(n, device, seed=SEED, scripted=None, join_only=False):
    """The real-member phase: the port's own ``Cluster`` (``ClusterBuilder`` on
    ``InProcessClient`` / ``InProcessServer``, default ``Settings``) against
    ``TpuSimMessaging(InProcessNetwork(VirtualScheduler()), n)`` on the
    port's default protocol. One member joins, votes in a crash of 1% of
    the virtual members (the closed form) and in one of 1% more under
    ingress loss 1.0 (the scan), and leaves: ``bridge_sequence``'s script
    with the same seed and victims. Then a second bridge: ``PORT_MEMBERS``
    members join in one pump and all vote in the first crash. After each
    decision every member's configuration id and member list equal the
    swarm's, and the ids those of a plain ``Simulator`` driven through the
    same identities, joins, crashes and leave. Each pump's wall (the pump
    and the virtual 200 ms after it that deliver the decision) is split into
    the simulator's dispatches, the members' own host work (``_MemberClock``:
    their protocol tasks; the join's view and service build apart), and the
    rest: the bridge's host work and the scheduler's delivery, with syncs by
    label and kernel launches, the calls that reached the port's native host
    library (``native.CALLS``) and the join's build by phase
    (``_MemberClock.split``). ``scripted``: ``bridge_sequence``'s result of
    the same run, whose pump walls are printed beside these. ``join_only``:
    the one member's join alone, then its leave unpumped."""
    from rapid_tpu_torch import ClusterBuilder, Settings, native
    from rapid_tpu_torch.messaging.inprocess import (InProcessClient, InProcessNetwork,
                                                     InProcessServer)
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.runtime.scheduler import VirtualScheduler
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.bridge import TpuSimMessaging
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig
    from rapid_tpu_torch.types import Endpoint, NodeId

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 10_000)  # bridge_sequence's victims
    victims = [np.sort(v) for v in np.split(rng.choice(n, 2 * (n // 100), replace=False), 2)]
    pumps = []
    clock = _MemberClock()

    def new_bridge():
        sched = VirtualScheduler()
        net = InProcessNetwork(sched)
        bridge = TpuSimMessaging(net, n, seed=seed, device=device)
        sim = bridge.sim
        timers = {"dispatch": 0.0}
        votes = []
        run, register = sim.run_until_decision, sim.register_extern_vote

        def timed(fn, key):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    timers[key] += time.perf_counter() - t0
            return call

        def counted_register(slot, cut):
            ok = register(slot, cut)
            votes.append((slot, ok))
            return ok

        sim.run_until_decision = timed(run, "dispatch")
        sim.register_extern_vote = counted_register
        return sched, net, bridge, timers, votes

    def member(net, sched, bridge, ep, i):
        settings = Settings()
        return (ClusterBuilder(ep)
                .set_messaging_client_and_server(InProcessClient(ep, net, settings),
                                                 InProcessServer(ep, net))
                .use_scheduler(sched).use_settings(settings)
                .use_rng(random.Random(MEMBER_RNG_SEED + i))
                .set_broadcaster_factory(
                    lambda client, rng: SwarmBroadcaster(client, net, bridge)))

    def pump(name, sched, bridge, timers, votes, clusters, real):
        """One pump and the virtual 200 ms that deliver its decision, with
        ``real`` real members in the swarm; the view of each of ``clusters``
        checked against the swarm's."""
        sim = bridge.sim
        n_before = sim.membership_size
        kernels.reset_launches()
        before = jitwatch.sync_counts()
        native_before = dict(native.CALLS)
        timers["dispatch"] = 0.0
        del votes[:]
        clock.reset()
        t0 = time.perf_counter()
        with clock:
            rec = bridge.pump()
            sched.run_for(200)  # the decision's packets to the members
        wall = time.perf_counter() - t0
        assert rec is not None, f"member pump, {name}: no decision"
        members = {bridge.endpoint(int(s)) for s in sim.members()}
        for c in clusters:
            assert c.get_current_configuration_id() == sim.configuration_id() \
                == rec.configuration_id, (name, str(c.listen_address))
            assert set(c.get_memberlist()) == members, (name, str(c.listen_address))
        row = {"name": name, "members_before": n_before, "cut": rec.cut.tolist(),
               "configuration_id": rec.configuration_id, "virtual_time_ms": rec.virtual_time_ms,
               "wall_ms": wall * 1e3, "dispatch_ms": timers["dispatch"] * 1e3,
               "member_ms": clock.ms, "member_build_ms": clock.build_ms,
               "host_ms": wall * 1e3 - timers["dispatch"] * 1e3 - clock.ms,
               "syncs": _diff(jitwatch.sync_counts(), before),
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "native_calls": {k: v - native_before[k] for k, v in native.CALLS.items()
                                if v != native_before[k]},
               "member_build_split": dict(clock.split),
               "votes_registered": list(votes), "real_members": real}
        pumps.append(row)
        return rec, row

    # --- one member: join, the two crashes, leave -------------------------
    sched, net, bridge, timers, votes = new_bridge()
    sim = bridge.sim
    ep = Endpoint.from_parts("10.77.0.2", 7000)
    promise = member(net, sched, bridge, ep, 0).join_async(bridge.endpoint(0))
    sched.run_for(50)  # phase 1 and 2: the joins park at their observers
    rec, row = pump("join", sched, bridge, timers, votes, [], 1)
    assert sched.run_until(promise.done, timeout_ms=10_000) and promise.exception() is None
    cluster = promise.peek()
    slot = bridge._slot_of[ep]  # noqa: SLF001
    assert rec.added.tolist() == [slot] and cluster.get_membership_size() == n + 1
    assert cluster.get_current_configuration_id() == sim.configuration_id() \
        == rec.configuration_id
    if join_only:
        node_id = NodeId.random(random.Random(MEMBER_RNG_SEED))
        cluster.shutdown()
        del cluster, promise, bridge, net, sched
        gc.collect()
        plain = Simulator(n, capacity=n + 16, config=SimConfig(capacity=n + 16,
                                                              extern_proposals=4),
                          seed=seed, device=device)
        plain.assign_identity(slot, ep.hostname, ep.port, node_id.high, node_id.low)
        plain.request_joins(np.array([slot]))
        prec = plain.run_until_decision(max_rounds=32, batch=8)
        row["plain_configuration_id"] = prec.configuration_id
        assert row["configuration_id"] == prec.configuration_id, (row, prec)
        return {"pumps": pumps}
    for name, fault, cut in (
            ("crash, closed form", lambda: sim.crash(victims[0]), victims[0]),
            ("crash, scan", lambda: (sim.crash(victims[1]), sim.ingress_loss(victims[1], 1.0)),
             victims[1])):
        fault()
        rec, row = pump(name, sched, bridge, timers, votes, [cluster], 1)
        assert rec.cut.tolist() == cut.tolist(), name
        assert row["votes_registered"] == [(slot, True)], (name, row["votes_registered"])
        if on_card and name == "crash, scan":
            assert row["launches"].get("fd_phase_fused", 0) > 0, row["launches"]
    before = rec.virtual_time_ms
    done = cluster.leave_gracefully_async()
    sched.run_for(50)
    rec, row = pump("leave", sched, bridge, timers, votes, [], 1)
    assert rec.cut.tolist() == [slot] and sched.run_until(done.done, timeout_ms=30_000)
    row["decided_in_ms"] = rec.virtual_time_ms - before
    identity = cluster._membership_service._view.get_configuration()  # noqa: SLF001
    node_id = NodeId.random(random.Random(MEMBER_RNG_SEED))
    assert node_id in identity.node_ids
    del cluster, identity, promise, bridge, net, sched
    gc.collect()

    # --- PORT_MEMBERS members: one join pump, all vote in the crash --------
    sched, net, bridge, timers, votes = new_bridge()
    sim = bridge.sim
    eps = [Endpoint.from_parts(f"10.77.1.{i + 1}", 7000) for i in range(PORT_MEMBERS)]
    promises = [member(net, sched, bridge, e, 1 + i).join_async(bridge.endpoint(0))
                for i, e in enumerate(eps)]
    sched.run_for(50)
    rec, row = pump(f"{PORT_MEMBERS} members join", sched, bridge, timers, votes, [],
                    PORT_MEMBERS)
    assert sched.run_until(lambda: all(p.done() for p in promises), timeout_ms=10_000)
    clusters = [p.peek() for p in promises]
    slots = [bridge._slot_of[e] for e in eps]  # noqa: SLF001
    assert sorted(rec.added.tolist()) == sorted(slots)
    assert all(c.get_current_configuration_id() == sim.configuration_id() for c in clusters)
    sim.crash(victims[0])
    rec, row = pump(f"{PORT_MEMBERS} members, crash", sched, bridge, timers, votes, clusters,
                    PORT_MEMBERS)
    assert rec.cut.tolist() == victims[0].tolist()
    assert sorted(row["votes_registered"]) == sorted((s, True) for s in slots), \
        row["votes_registered"]
    for c in clusters:
        c.shutdown()
    del clusters, promises, bridge, net, sched
    gc.collect()  # the members' views, in reference cycles: freed outside any timed pump

    # --- the cross-check: plain simulators driven alike, with no bridge ---
    def plain_run(identities, steps):
        plain = Simulator(n, capacity=n + 16, config=SimConfig(capacity=n + 16,
                                                              extern_proposals=4),
                          seed=seed, device=device)
        for s, (e, nid) in identities.items():
            plain.assign_identity(s, e.hostname, e.port, nid.high, nid.low)
        ids = []
        for step in steps:
            step(plain)
            prec = plain.run_until_decision(max_rounds=32, batch=8)
            assert prec is not None
            ids.append(prec.configuration_id)
        return ids

    one = plain_run({slot: (ep, node_id)}, (
        lambda p: p.request_joins(np.array([slot])), lambda p: p.crash(victims[0]),
        lambda p: (p.crash(victims[1]), p.ingress_loss(victims[1], 1.0)),
        lambda p: p.leave(np.array([slot]))))
    many = plain_run({s: (e, NodeId.random(random.Random(MEMBER_RNG_SEED + 1 + i)))
                      for i, (s, e) in enumerate(zip(slots, eps))},
                     (lambda p: p.request_joins(np.array(slots)), lambda p: p.crash(victims[0])))
    for row, want in zip(pumps, one + many):
        row["plain_configuration_id"] = want
        assert row["configuration_id"] == want, (row["name"], row["configuration_id"], want)
    scripted_walls = {p["name"]: p["wall_ms"] for p in (scripted or {}).get("pumps", [])}
    scripted_walls[f"{PORT_MEMBERS} members join"] = scripted_walls.get("join")
    scripted_walls[f"{PORT_MEMBERS} members, crash"] = scripted_walls.get("crash, closed form")
    for row in pumps:
        beside = scripted_walls.get(row["name"])
        print(f"member pump, {row['name']}: {row['members_before']} members, "
              f"{row['real_members']} real, cut {len(row['cut'])}, "
              f"configuration id {row['configuration_id']} (== every member's == the plain "
              f"simulator's), virtual {row['virtual_time_ms']} ms; wall {row['wall_ms']:.3f} ms "
              f"= dispatch {row['dispatch_ms']:.3f} + the members' host {row['member_ms']:.3f} "
              f"(view and service build {row['member_build_ms']:.3f}) + bridge host and "
              f"delivery {row['host_ms']:.3f}; votes registered "
              f"{len(row['votes_registered'])}; syncs by label {row['syncs']}; kernel launches "
              f"{row['launches']}; native calls {row['native_calls']}"
              + (f"; the build by phase {_split_text(row['member_build_split'])}"
                 if row["member_build_ms"] else "")
              + ("" if beside is None else f"; the scripted member's pump {beside:.3f} ms")
              + (f"; decided in {row['decided_in_ms']} ms virtual" if "decided_in_ms" in row
                 else ""), flush=True)
    return {"pumps": pumps}


JOURNAL_KINDS = ("view_install", "view_refused", "kicked", "decision", "proposal", "alert_in",
                 "alert_out", "fd_signal")


def _agent_fork_dump(row, reply, child, probe, swarm_size):
    """What names the cause when the agent's status disagrees with the
    gateway: both ids and sizes, the agent's journal from the same status
    reply (``view_install`` carries the id its protocol thread installed),
    each VIEW_CHANGE line the agent logged (its id and its UP and DOWN
    counts), and the bridge's repair paths (``_RedriveLog``)."""
    journal = []
    for raw in reply.journal:
        entry = json.loads(raw)
        if entry.get("kind") in JOURNAL_KINDS:
            journal.append((entry.get("kind"), entry.get("virtual_ms"), entry.get("detail")))
    views = []
    for _, line in child.lines:
        if " VIEW_CHANGE config=" in line:
            config = line.split(" VIEW_CHANGE config=", 1)[1].split(" ", 1)[0]
            views.append((config, line.count(":UP:"), line.count(":DOWN:")))
    return json.dumps({
        "step": row["name"], "gateway_configuration_id": row["configuration_id"],
        "agent_configuration_id": reply.configuration_id,
        "agent_membership_size": reply.membership_size,
        "gateway_membership_size": swarm_size,
        "agent_journal": journal, "agent_view_changes": views,
        "agent_warnings": [line[:300] for _, line in child.lines
                           if " WARNING " in line or " ERROR " in line][-10:],
        "bridge_repair_paths": probe.redrives.tail()}, default=str)


def _split_text(split):
    return ", ".join(f"{label} {ms:.3f} ms" for label, ms in split.items())


class _AgentChild:
    """``python -m rapid_tpu_torch.cli.agent`` in its own OS process: its log
    lines (standard error) read by a thread, each with the time it arrived;
    every wait bounded; killed if it outlives ``close``."""

    def __init__(self, args):
        here = os.path.dirname(os.path.abspath(__file__))
        self.started = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "rapid_tpu_torch.cli.agent", *args], cwd=here,
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, PYTHONUNBUFFERED="1"))
        self.lines = []  # (arrival time, line)
        self._cond = threading.Condition()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append((time.time(), line.rstrip()))
                self._cond.notify_all()

    def wait(self, text, after=0, timeout=GATEWAY_WAIT_S):
        """The first line from index ``after`` on that holds ``text``:
        (its index, its arrival time, the line)."""
        deadline = time.time() + timeout
        with self._cond:
            while True:
                for i in range(after, len(self.lines)):
                    if text in self.lines[i][1]:
                        return i, self.lines[i][0], self.lines[i][1]
                left = deadline - time.time()
                if left <= 0 or self.proc.poll() is not None and after >= len(self.lines):
                    raise AssertionError(f"agent: no '{text}' line in {timeout} s; exit "
                                         f"{self.proc.poll()}; last lines "
                                         f"{[line for _, line in self.lines[-20:]]}")
                self._cond.wait(min(left, 0.5))

    def close(self):
        try:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGINT)
                self.proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def agent_sequence(n, device, seed=SEED, scripted=None, transport="tcp", native_server=False,
                   label="agent", beside="the scripted member's"):
    """The agent phase: the port's ``SwarmGateway`` on 127.0.0.1 hosting ``n``
    virtual members (``GATEWAY_SETTINGS``, as ``gateway_sequence``), and
    ``python -m rapid_tpu_torch.cli.agent`` in a child process: a real port
    ``Cluster`` on the port's TCP transport, routed through the gateway
    (``--gateway-address``), joining at the swarm's seed. It joins, goes
    through a crash of 1% of the virtual members (the closed form) and one
    of 1% more under ingress loss 1.0 (the scan), both run on the gateway's
    protocol thread, and leaves on SIGINT (and exits 0). After the join and
    each crash the agent's configuration id, read through its status RPC
    (``cli.agent.query_status``), equals the gateway's; the leave's decision
    cuts the agent's slot; every decision's id equals that of a plain
    ``Simulator`` driven through the same identity (the one the agent
    seated), joins, crashes and leave. Each step: the wall from the fault
    (from the agent's start, for the join; to its exit, for the leave) to
    the agent's log line of the view change, the decision pump's wall split
    as ``gateway_sequence`` splits it, the agent's vote (whether the swarm
    registered it in the phase-B window), syncs by label and kernel
    launches. ``scripted``: ``gateway_sequence``'s (or an earlier agent
    run's) result of the same run, whose step walls are printed beside these,
    as ``beside``. ``transport``: the agent's ``--transport``;
    ``native_server``: the gateway's front door on the C++ epoll reactor;
    ``label`` starts each printed line."""
    from rapid_tpu_torch.cli.agent import query_status
    from rapid_tpu_torch.messaging.gateway import SwarmGateway
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig
    from rapid_tpu_torch.types import ClusterStatusResponse, Endpoint

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 20_000)  # gateway_sequence's victims
    victims = [np.sort(v) for v in np.split(rng.choice(n, 2 * (n // 100), replace=False), 2)]
    gw_port, agent_port = _free_ports(2)
    agent_addr = f"127.0.0.1:{agent_port}"
    agent_ep = Endpoint.from_string(agent_addr)
    gateway = SwarmGateway(Endpoint.from_parts("127.0.0.1", gw_port), n_virtual=n, seed=seed,
                           settings=Settings(**GATEWAY_SETTINGS),
                           pump_interval_ms=GATEWAY_PUMP_MS, native_server=native_server,
                           device=device)
    bridge, sim = gateway.bridge, gateway.bridge.sim
    probe = _GatewayProbe(gateway, on_card)
    slot = n  # the first spare slot seats the joiner
    steps, child, seen_line = [], None, [0]

    def check_status(row):
        """The agent's status RPC after a step: its configuration id must be
        the gateway's decision, or the run fails naming what each side saw."""
        reply = query_status(agent_addr, GATEWAY_WAIT_S)
        assert isinstance(reply, ClusterStatusResponse), reply
        row["agent_configuration_id"] = reply.configuration_id
        row["agent_membership_size"] = reply.membership_size
        assert (reply.configuration_id, reply.membership_size) == (
            row["configuration_id"], sim.membership_size), _agent_fork_dump(
                row, reply, child, probe, sim.membership_size)

    def step(name, act, cut_slots, until):
        """``act()`` starts the step and returns when; ``until()`` returns
        when the agent showed its end."""
        n_before = sim.membership_size
        probe.reset()
        kernels.reset_launches()
        start = act()
        decision = probe.wait_decision(name)
        rec = decision["rec"]
        assert sorted(rec.cut.tolist()) == sorted(int(s) for s in cut_slots), name
        seen = until()
        time.sleep(3 * GATEWAY_PUMP_MS / 1e3)  # the next pumps see nothing to do
        work, votes, syncs, counted = probe.take()
        row = {"name": name, "members_before": n_before, "cut": len(rec.cut),
               "configuration_id": rec.configuration_id, "virtual_time_ms": rec.virtual_time_ms,
               "agent_wall_ms": (seen - start) * 1e3, "pumps_with_work": len(work),
               "pump_wall_ms": decision["wall_ms"], "dispatch_ms": decision["dispatch_ms"],
               "vote_window_ms": decision["vote_window_ms"],
               "host_ms": decision["wall_ms"] - decision["dispatch_ms"]
               - decision["vote_window_ms"],
               "pump_syncs": decision["syncs"], "pump_launches": decision["launches"],
               "syncs": syncs, "counted_syncs": counted if on_card else None,
               "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
               "vote_registered": (slot, True) in votes}
        steps.append(row)
        return row

    def logged(text):
        def until():
            index, seen, _ = child.wait(text, seen_line[0], timeout=AGENT_JOIN_TIMEOUT_S)
            seen_line[0] = index + 1
            return seen
        return until

    def spawn():
        nonlocal child
        child = _AgentChild([
            "--listen-address", agent_addr, "--seed-address", str(gateway.seed_endpoint()),
            "--gateway-address", f"127.0.0.1:{gw_port}", "--fd-interval-ms",
            str(GATEWAY_SETTINGS["failure_detector_interval_ms"]), "--join-timeout",
            str(AGENT_JOIN_TIMEOUT_S), "--transport", transport])
        return child.started

    def on_protocol_thread(fault):
        def act():
            t = time.time()
            _on_protocol_thread(gateway, fault)
            return t
        return act

    def sigint():
        t = time.time()
        child.proc.send_signal(signal.SIGINT)
        return t

    def exited():
        rc = child.proc.wait(timeout=GATEWAY_WAIT_S)
        assert rc == 0, (rc, [line for _, line in child.lines[-20:]])
        return time.time()

    try:
        gateway.start()
        t0 = time.perf_counter()
        gateway.warm()
        warm_s = time.perf_counter() - t0
        row = step("join", spawn, [slot], logged("agent started at"))
        assert bridge._slot_of[agent_ep] == slot  # noqa: SLF001
        identity = (int(sim.cluster.id_high[slot]), int(sim.cluster.id_low[slot]))
        check_status(row)
        for name, fault, cut in (
                ("crash, closed form", lambda v=victims[0]: sim.crash(v), victims[0]),
                ("crash, scan", lambda v=victims[1]: (sim.crash(v), sim.ingress_loss(v, 1.0)),
                 victims[1])):
            row = step(name, on_protocol_thread(fault), cut, logged("VIEW_CHANGE config="))
            check_status(row)
            if on_card and name == "crash, scan":
                assert row["pump_launches"].get("fd_phase_fused", 0) > 0, row["pump_launches"]
        step("leave", sigint, [slot], exited)
        assert agent_ep not in bridge._real  # noqa: SLF001
    finally:
        if child is not None:
            child.close()
        gateway.shutdown()
        for thread in gateway._threads:  # noqa: SLF001 -- a pump in flight ends first
            thread.join(timeout=GATEWAY_WAIT_S)
    if on_card:
        for row in steps:
            assert row["counted_syncs"] == sum(row["syncs"].values()), (
                row["name"], row["counted_syncs"], row["syncs"])

    # the cross-check: a plain simulator driven alike, with no gateway
    plain = Simulator(n, capacity=n + 16, config=SimConfig(capacity=n + 16, extern_proposals=4),
                      seed=seed, device=device)
    plain.assign_identity(slot, agent_ep.hostname, agent_ep.port, *identity)
    for row, act in zip(steps, (lambda: plain.request_joins(np.array([slot])),
                                lambda: plain.crash(victims[0]),
                                lambda: (plain.crash(victims[1]),
                                         plain.ingress_loss(victims[1], 1.0)),
                                lambda: plain.leave(np.array([slot])))):
        act()
        prec = plain.run_until_decision(max_rounds=32, batch=8)
        assert prec is not None
        row["plain_configuration_id"] = prec.configuration_id
        assert row["configuration_id"] == prec.configuration_id, (row["name"], prec)
    scripted_walls = {r["name"]: r.get("member_wall_ms", r.get("agent_wall_ms"))
                      for r in (scripted or {}).get("steps", [])}
    for row in steps:
        beside_ms = scripted_walls.get(row["name"])
        print(f"{label}, {row['name']}: {row['members_before']} members, cut {row['cut']}, "
              f"configuration id {row['configuration_id']} (== the plain simulator's"
              + (", == the agent's status RPC" if "agent_configuration_id" in row else
                 "; the agent exited 0") + f"), virtual {row['virtual_time_ms']} ms; wall as "
              f"the agent sees it {row['agent_wall_ms']:.3f} ms"
              + ("" if beside_ms is None else f" ({beside} {beside_ms:.3f} ms)")
              + f"; decision pump {row['pump_wall_ms']:.3f} ms = dispatch "
              f"{row['dispatch_ms']:.3f} + vote window {row['vote_window_ms']:.3f} + bridge "
              f"host {row['host_ms']:.3f}; the agent's vote registered in the window: "
              f"{row['vote_registered']}; the decision pump's syncs by label "
              f"{row['pump_syncs']} and launches {row['pump_launches']}; the step's "
              f"{row['pumps_with_work']} pumps with device work and every other protocol task: "
              f"syncs {row['syncs']}"
              + ("" if row["counted_syncs"] is None else
                 f" (debug mode counted {row['counted_syncs']})")
              + f", launches {row['launches']}", flush=True)
    print(f"{label} phase: gateway warm() {warm_s:.3f} s", flush=True)
    return {"warm_s": warm_s, "steps": steps, "transport": transport,
            "native_server": native_server}


def wire_phase(card, reps=5):
    """The port's codec replays ``tests/golden/torch_wire_frames.json``
    (frames ``rapid_tpu``'s codec wrote) byte for byte and decodes each
    back to an equal message, with no C MessagePack library in the process;
    then each frame class's encode and decode time (median of ``reps``,
    fresh message objects, so no memo hits), and one run each of a
    100k-member ``JoinResponse``, a 75 001-sender ``FastRoundVoteBatch`` and
    an announcement of 1000 alerts."""
    sys.path.insert(0, os.path.dirname(WIRE_FRAMES))
    import torch_wire_fixtures as fx

    assert "msgpack" not in sys.modules, "a C MessagePack library is loaded"
    wire = fx.port_wire()
    with open(WIRE_FRAMES) as f:
        frames = json.load(f)["frames"]
    classes = {}
    for frame in frames:
        data = bytes.fromhex(frame["hex"])
        assert fx.frame_bytes(frame, wire) == data, frame["name"]
        want = fx.message(frame, wire)
        if frame["routed"] is not None:
            got = wire.decode_routed(data)[2]
        else:
            got = wire.decode(memoryview(data))[1]
        assert got == want and type(got) is type(want), frame["name"]
        enc, dec = [], []
        for _ in range(reps):
            msg = fx.message(frame, wire)
            t0 = time.perf_counter()
            fx.encode_frame(frame, msg, wire)
            enc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            wire.decode_routed(data) if frame["routed"] is not None else wire.decode(data)
            dec.append(time.perf_counter() - t0)
        cls = type(want).__name__
        entry = classes.setdefault(cls, {"frames": 0, "bytes": 0, "encode_ms": 0.0,
                                         "decode_ms": 0.0})
        entry["frames"] += 1
        entry["bytes"] = max(entry["bytes"], len(data))
        entry["encode_ms"] = max(entry["encode_ms"], statistics.median(enc) * 1e3)
        entry["decode_ms"] = max(entry["decode_ms"], statistics.median(dec) * 1e3)
    T = wire.types
    big = {}
    for name, make in (
            ("JoinResponse, 100 001 endpoints and identifiers", lambda: T.JoinResponse(
                T.Endpoint(b"10.0.0.1", 5000), T.JoinStatusCode.SAFE_TO_JOIN,
                -4651904502688146028, fx.endpoints(T, 100_001, 5000), fx.node_ids(T, 100_001, 1))),
            ("FastRoundVoteBatch, 75 001 senders, a 1000-member cut", lambda: T.FastRoundVoteBatch(
                fx.endpoints(T, 75_001, 5000), -4651904502688146028,
                fx.endpoints(T, 1000, 6000))),
            ("BatchedAlertMessage, an announcement of 1000 alerts on 10 rings",
             lambda: T.BatchedAlertMessage(T.Endpoint(b"10.0.0.1", 5000), tuple(
                 T.AlertMessage(T.Endpoint(b"10.0.0.1", 5000), e, T.EdgeStatus.DOWN,
                                -4651904502688146028, tuple(range(10)))
                 for e in fx.endpoints(T, 1000, 6000))))):
        msg = make()
        t0 = time.perf_counter()
        data = wire.encode(7, msg)
        t1 = time.perf_counter()
        back = wire.decode(data)[1]
        t2 = time.perf_counter()
        assert back == msg
        big[name] = {"bytes": len(data), "encode_ms": (t1 - t0) * 1e3,
                     "decode_ms": (t2 - t1) * 1e3}
    print(f"wire: the port's codec gives all {len(frames)} golden frames byte for byte and "
          f"decodes each back to an equal message ({len(classes)} classes, no C MessagePack "
          f"library in the process) ({card})", flush=True)
    for cls, e in sorted(classes.items()):
        print(f"wire, {cls}: {e['frames']} frames, largest {e['bytes']} B, encode "
              f"{e['encode_ms']:.4f} ms, decode {e['decode_ms']:.4f} ms (median of {reps}, the "
              f"slowest frame of the class)", flush=True)
    for name, e in big.items():
        print(f"wire, {name}: {e['bytes']} B, encode {e['encode_ms']:.3f} ms, decode "
              f"{e['decode_ms']:.3f} ms (one run, no memo) ({card})", flush=True)
    return {"frames": len(frames), "classes": classes, "large": big}


PROTO_BIG = "JoinResponse_100000_endpoints"  # its encode and decode are timed


def proto_frame_miss(frame, wire):
    """Where the port's gRPC conversions (``messaging/grpc_transport.py``)
    depart from a frame of ``tests/golden/torch_proto_frames.json``, or None:
    they must give its bytes (or, where the JAX conversion refused the
    message, raise the same class of error), decode them to a message that
    encodes to the same bytes again, and carry the trace context and the HLC
    stamp across (an incarnation below 1 arrives as 1, as in JAX)."""
    import dataclasses
    import hashlib

    import torch_wire_fixtures as fx

    from rapid_tpu_torch.messaging import grpc_transport

    request = frame["direction"] == "request"
    to_wire = grpc_transport.to_wire_request if request else grpc_transport.to_wire_response
    back = grpc_transport.from_wire_request if request else grpc_transport.from_wire_response
    name = frame["name"]
    try:
        msg = fx.message(frame, wire)
        data = to_wire(msg)
    except (TypeError, ValueError) as exc:
        if frame.get("error") == type(exc).__name__:
            return None
        return f"{name}: raised {type(exc).__name__}: {exc}"
    if "error" in frame:
        return f"{name}: gave bytes where the JAX conversion raised {frame['error']}"
    if "hex" in frame and data.hex() != frame["hex"]:
        return f"{name}: bytes differ"
    if "sha256" in frame and (len(data), hashlib.sha256(data).hexdigest()) != (
            frame["size"], frame["sha256"]):
        return f"{name}: bytes differ ({len(data)} B against {frame['size']})"
    got = back(data)
    stamp = wire.hlc_of(msg) if request else None
    if stamp is not None and stamp.incarnation < 1:
        wire.stamp_hlc(msg, dataclasses.replace(stamp, incarnation=1))
        data = to_wire(msg)
    if to_wire(got) != data:
        return f"{name}: the decoded message encodes to other bytes"
    if request and ((wire.trace_context_of(got), wire.hlc_of(got))
                    != (wire.trace_context_of(msg), wire.hlc_of(msg))):
        return f"{name}: the trace context or the HLC stamp did not cross"
    return None


def proto_phase(card, reps=3, without_protobuf=True):
    """The port's proto3 codec of the gRPC wire against
    ``tests/golden/torch_proto_frames.json`` (frames ``rapid_tpu`` and
    protobuf wrote), with no protobuf in the process: every frame through
    ``proto_frame_miss``; then the 100k ``JoinResponse``'s encode and decode
    beside the msgpack codec's for the same message (median of ``reps``,
    each on a fresh message object). ``without_protobuf`` holds that no
    protobuf module is loaded (the tests, which load it, pass False)."""
    sys.path.insert(0, os.path.dirname(WIRE_FRAMES))
    import torch_wire_fixtures as fx

    from rapid_tpu_torch.messaging import grpc_transport

    assert not without_protobuf or "google.protobuf" not in sys.modules, "protobuf is loaded"
    wire = fx.port_wire()
    with open(PROTO_FRAMES) as f:
        frames = json.load(f)["frames"]
    misses = [m for m in (proto_frame_miss(frame, wire) for frame in frames) if m]
    assert not misses, f"proto: {len(misses)} frames differ: " + "; ".join(misses[:5])
    big_frame = next(f for f in frames if f["name"] == PROTO_BIG)
    walls = {}
    for codec, encode, decode in (
            ("proto3", grpc_transport.to_wire_response, grpc_transport.from_wire_response),
            ("msgpack", lambda m: wire.encode(7, m), lambda d: wire.decode(d)[1])):
        enc, dec = [], []
        for _ in range(reps):
            big = fx.message(big_frame, wire)  # a fresh message: no memo hits
            t0 = time.perf_counter()
            data = encode(big)
            t1 = time.perf_counter()
            got = decode(data)
            dec.append((time.perf_counter() - t1) * 1e3)
            enc.append((t1 - t0) * 1e3)
            assert got == big, codec
        walls[codec] = {"bytes": len(data), "encode_ms": statistics.median(enc),
                        "decode_ms": statistics.median(dec)}
    errors = sum(1 for f in frames if "error" in f)
    print(f"proto: the port's gRPC conversions give all {len(frames)} golden frames of "
          f"tests/golden/torch_proto_frames.json ({errors} of them refused as JAX refuses them) "
          f"and decode each back, with no protobuf in the process ({card})", flush=True)
    print(f"proto, {PROTO_BIG}: proto3 {walls['proto3']['bytes']} B, encode "
          f"{walls['proto3']['encode_ms']:.1f} ms, decode {walls['proto3']['decode_ms']:.1f} ms; "
          f"msgpack {walls['msgpack']['bytes']} B, encode {walls['msgpack']['encode_ms']:.1f} ms, "
          f"decode {walls['msgpack']['decode_ms']:.1f} ms (median of {reps}) ({card})",
          flush=True)
    return {"frames": len(frames), "refused": errors, "join_response_100k": walls}


def decode_capture(data: bytes, client_side: bool) -> dict:
    """One direction of a captured HTTP/2 connection as the port's
    ``messaging/http2.py`` reads it: its frames (name, flags, stream,
    length) and its header blocks (stream, headers), through one HPACK
    decoder in arrival order. The client's side opens with the connection
    preface."""
    from rapid_tpu_torch.messaging import http2

    if client_side:
        assert data.startswith(http2.PREFACE), "no connection preface"
        data = data[len(http2.PREFACE):]
    found = http2.FrameReader().feed(data)
    assert sum(9 + len(f.payload) for f in found) == len(data), "a truncated frame"
    decoder = http2.Decoder()
    frames, blocks, block = [], [], None
    for f in found:
        frames.append([http2.FRAME_NAMES[f.type] if f.type < len(http2.FRAME_NAMES) else f.type,
                       f.flags, f.stream_id, len(f.payload)])
        if f.type == http2.HEADERS:
            block = bytearray(http2.frame_body(f))
        elif f.type == http2.CONTINUATION:
            block += f.payload
        if f.type in (http2.HEADERS, http2.CONTINUATION) and f.flags & http2.END_HEADERS:
            blocks.append({"stream": f.stream_id,
                           "headers": [list(h) for h in decoder.decode(bytes(block))]})
    return {"frames": frames, "blocks": blocks}


# --------------------------------------------------------------------- #
# The driver's host planes: placement (on placement_topr), handoff,
# serving, SLO, durability and hierarchy
# --------------------------------------------------------------------- #

# the bench's serving dimension (bench.py SERVING_*)
SERVING_N_NODES = 64
SERVING_PARTITIONS = 256
SERVING_KEYS = 64
SERVING_OPS = (("steady", 300), ("view_change_window", 150), ("post_view", 150))
SERVING_PUT_FRACTION = 0.2
SERVING_RATE_PER_S = 600.0
SERVING_ZIPF_S = 1.1
SERVING_CLIENTS = 1_000_000
SERVING_SLO_WINDOW_SCALE = 0.001
# the bench sweep's placement point (bench.py run_sweep / warmed_run)
SWEEP_N = 10_000
SWEEP_PARTITIONS = 1024
# hierarchy-zone-churn at its defaults (scenarios.py)
ZONE_CHURN = {"seed": 19, "zones": 8, "per_zone": 256}
# the full-width path: test_sim_placement_at_scale's map, every plane on
PLANES_PARTITIONS = 8192
PLANES_REPLICAS = 3
PLANES_CELLS = 8
PLANES_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "golden", "torch_planes.json")
HANDOFF_METRICS = (
    "handoff.sessions_started", "handoff.sessions_completed",
    "handoff.sessions_failed", "handoff.chunks_sent", "handoff.chunks_received",
    "handoff.chunks_duplicate", "handoff.bytes_moved", "handoff.retries",
    "handoff.failovers", "handoff.releases",
)
# placement_topr's bound: the INT32 lanes of an H100 SXM (132 SMs x 64 lanes a
# clock) at its 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# operations a scored (row, column) pair costs: per virtual instance the
# mix (xor, two multiplies, two shifts, two xors) and a max, then the compare
# against the row's R-th best
TOPR_OPS_PER_INSTANCE = 8
TOPR_OPS_PER_PAIR = 1
TOPR_CASES = (
    # (name, rows, columns, replicas, weights from..to, inactive share)
    ("full build [8192, 100000], R 3, V 1", 8192, 100_000, 3, (1, 1), 0.01),
    ("weighted [1024, 100000], R 3, weights 1-8", 1024, 100_000, 3, (1, 8), 0.01),
)
TOPR_MERGE = ("merge of 1000 added columns into 8192 prior rows, R 3", 8192, 100_000, 3, 1000)
TOPR_VIEW_CHANGE = "the planes path's view change, its affected rows x 100000, R 3"
TOPR_COLD_BYTES = 2 * 50 * 2**20  # cold runs rotate input sets past 2x the L2
# the parent commit's placement_topr, from a git archive of that commit unpacked
# under build/parent (never committed): timed beside the kernel in turns
# where it is there
TOPR_PARENT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parent",
                               "rapid_tpu_torch", "csrc", "placement_topr.cu")


def start_topr_builds():
    """Start, beside the kernel build: ``placement_topr.cu``'s device code
    with ``-Xptxas -v`` (registers and spills of every instantiation) and,
    where ``TOPR_PARENT_SRC`` exists, the parent commit's kernel as a library
    of its own. Returns ``{name: (process, output path)}``;
    ``finish_topr_builds`` waits for them."""
    from rapid_tpu_torch.sim import kernels

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "topr")
    os.makedirs(out_dir, exist_ok=True)
    src = str(kernels._CSRC / "placement_topr.cu")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    jobs = {"ptxas": ([kernels._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
                       os.path.join(out_dir, "placement_topr.cubin"), src], None)}
    if os.path.exists(TOPR_PARENT_SRC):
        lib = os.path.join(out_dir, "placement_topr_parent.so")
        jobs["parent"] = ([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, TOPR_PARENT_SRC], lib)
    return {name: (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True), out)
            for name, (cmd, out) in jobs.items()}


def finish_topr_builds(builds, card):
    """Wait for ``start_topr_builds``' jobs: print every instantiation's
    registers, stack and spills (none may spill), and load the parent
    commit's kernel when it was built. Returns ``(ptxas rows, its entry point
    or None)``."""
    import ctypes
    import re

    rows = []
    parent = None
    for name, (proc, out) in builds.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc ({name}) failed:\n{log}"
        if name == "parent":
            fn = ctypes.CDLL(out).placement_topr
            p, q, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            fn.argtypes = [p, q, p, q, i, p, p, p, q, p, p, i, p]  # the plan-less entry
            fn.restype = ctypes.c_int
            parent = fn
            continue
        current = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*topr_kernelILi(\d+)E", line)
            if m:
                current = {"R": int(m.group(1))}
                rows.append(current)
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
    rows.sort(key=lambda r: r["R"])
    assert len(rows) == 16, f"ptxas reported {len(rows)} instantiations, want 16"
    text = "; ".join(f"R{r['R']}: {r.get('registers')} regs, "
                     f"{r.get('stack')} B stack, {r.get('spill_stores')}/{r.get('spill_loads')} "
                     f"B spilled" for r in rows)
    print(f"placement_topr -Xptxas -v (sm_90a; registers, stack, spill stores/loads; "
          f"shared memory is dynamic, the plan's): {text} ({card})", flush=True)
    assert all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 for r in rows), rows
    return rows, parent


def _kv_digest(sim):
    """The serving oracle as JSON: hex key -> [version, hex value]."""
    return {k.hex(): [int(v), b.hex()] for k, (v, b) in sorted(sim.serving_acked.items())}


def _record_digest(rec):
    return {"cut": sorted(int(c) for c in rec.cut), "configuration_id": int(rec.configuration_id),
            "virtual_time_ms": int(rec.virtual_time_ms),
            "membership_size": int(rec.membership_size)}


def drive_open_loop(sim, gen, n_ops):
    """One serving window of the bench's: the arrival clock rebased to the
    simulator's, ``n_ops`` open-loop arrivals driven. Returns the window's
    statuses, latencies, elapsed virtual ms and end time."""
    gen.rebase(sim.virtual_ms)
    t0 = sim.virtual_ms
    results = sim.serving_drive_open_loop(gen.arrivals(n_ops))
    return {"statuses": [int(s) for _a, s, _l in results],
            "latencies_ms": [float(lat) for _a, _s, lat in results],
            "elapsed_ms": float(max(sim.virtual_ms - t0, 1)), "virtual_ms": int(sim.virtual_ms)}


def _lost_acked(sim):
    lost = 0
    for key, (version, _value) in sim.serving_acked.items():
        back = sim.serving_get(key)
        if back.status != back.STATUS_OK or back.version < version:
            lost += 1
    return lost


def serving_dimension_run(Simulator, SLOSettings, OpenLoopGenerator, seed=SEED, **sim_kw):
    """The bench's serving dimension as written (``bench.run_serving_dimension``):
    64 members, 256 partitions, placement, handoff, serving and the SLO plane;
    a preload, then open-loop windows steady, through a crash (the churn
    window) and after the decided view. Takes either package's classes, so
    ``tests/golden/generate_torch_planes.py`` records the JAX package's run
    and the port's is held to it. Returns the run as JSON-ready data."""
    rng = np.random.default_rng(seed)
    sim = Simulator(SERVING_N_NODES, seed=seed, **sim_kw)
    sim.enable_placement(partitions=SERVING_PARTITIONS)
    sim.enable_handoff()
    sim.enable_serving()
    plane = sim.enable_slo(SLOSettings(enabled=True, window_scale=SERVING_SLO_WINDOW_SCALE))
    keys = [b"bench-key-%04d" % i for i in range(SERVING_KEYS)]
    for i, key in enumerate(keys):
        assert sim.serving_put(key, b"seed-%d" % i).status == 0, "preload write failed"
    gen = OpenLoopGenerator(SERVING_RATE_PER_S, keys, put_fraction=SERVING_PUT_FRACTION,
                            seed=seed, zipf_s=SERVING_ZIPF_S, clients=SERVING_CLIENTS)
    versions = [int(sim.placement.version)]
    windows = {}
    windows["steady"] = drive_open_loop(sim, gen, SERVING_OPS[0][1])
    victim = int(rng.integers(1, SERVING_N_NODES))
    sim.crash(np.array([victim]))
    windows["view_change_window"] = drive_open_loop(sim, gen, SERVING_OPS[1][1])
    rec = sim.run_until_decision(max_rounds=64, batch=16)
    assert rec is not None and set(int(c) for c in rec.cut) == {victim}, "cut parity"
    versions.append(int(sim.placement.version))
    windows["post_view"] = drive_open_loop(sim, gen, SERVING_OPS[2][1])
    return {
        "victim": victim, "record": _record_digest(rec), "windows": windows,
        "lost_acked_writes": _lost_acked(sim), "acked": _kv_digest(sim),
        "virtual_ms": int(sim.virtual_ms), "placement_versions": versions,
        "moved": [int(d.moved) for d in sim.placement_diffs],
        "handoff": {m: int(sim.metrics.get(m)) for m in HANDOFF_METRICS},
        "slo": plane.summary(sim.virtual_ms),
    }


def sweep_point_digest(sim, rec):
    """What the golden file holds of the sweep's placement point: the timed
    simulator's record, its placement versions before and after the view
    change, the moved partitions, the handoff counters and transfers."""
    diffs = sim.placement_diffs
    return {
        "record": _record_digest(rec),
        "placement_versions": [int(diffs[0].old_version), int(sim.placement.version)],
        "moved": [int(d.moved) for d in diffs],
        "moved_partitions": [int(p) for p in diffs[0].partitions_moved],
        "handoff": {m: int(sim.metrics.get(m)) for m in HANDOFF_METRICS},
        "transfers": len(sim.handoff_transfers[0]), "virtual_ms": int(sim.virtual_ms),
    }


def sweep_point_run(n=SWEEP_N, partitions=SWEEP_PARTITIONS, seed=SEED, device=None,
                    details=None):
    """The bench sweep's placement point on the port: ``scaling_sweep.
    warmed_run(n, placement_partitions=partitions, handoff_partitions=
    partitions)``, which asserts the cut, minimal motion and every handoff
    session completed, and its timed simulator's ``sweep_point_digest``.
    ``details`` gets ``warmed_run``'s, and the timed decision's
    ``wall_ms``."""
    from rapid_tpu_torch.experiments.scaling_sweep import warmed_run

    details = {} if details is None else details
    details["wall_ms"], rec, _, _ = warmed_run(
        n, seed, placement_partitions=partitions, handoff_partitions=partitions,
        device=device, details=details)
    return sweep_point_digest(details.pop("sim"), rec)


def _hierarchy_rows(sim):
    return [[int(r.cell), int(r.epoch), int(r.size), r.leader, int(r.fingerprint)]
            for r in sim.hierarchy_rows()]


def zone_churn_run(Simulator, SimConfig, LatencyTopology, Endpoint, cell_leaders,
                   seed=19, zones=8, per_zone=256, result=None, **sim_kw):
    """``scenarios.py``'s hierarchy-zone-churn: ``zones`` topology cells of
    ``per_zone`` members, a scatter of 8 crashes across cells, then one
    whole cell, its leader included, killed. Returns the cells, the rows,
    the parent rounds and the global fingerprints after each step; with
    ``result`` (the port's ``cli.scenarios.zone_churn_result``) also the
    registry scenario's record under "scenario", so the scenarios phase
    reports this run and does not drive the scenario a second time."""
    n = zones * per_zone
    topo = LatencyTopology(racks=zones * 2, zones=zones, rack_rtt_ms=0, zone_rtt_ms=2,
                           region_rtt_ms=4, inter_region_rtt_ms=8)
    rng = np.random.default_rng(seed)
    sim = Simulator(n, config=SimConfig(capacity=n, groups=8), seed=seed, **sim_kw)
    sim.enable_hierarchy(topology=topo, parent_round_ms=4)
    fingerprints = [int(sim.global_fingerprint())]
    lost_zone = int(rng.integers(zones))
    zone_victims = [i for i in range(n) if topo.zone_of(i) == lost_zone]
    members = [Endpoint(hostname=h, port=p) for h, p in (sim.endpoint_of(s) for s in zone_victims)]
    leader = str(cell_leaders(members, 1)[0])
    others = [i for i in range(n) if topo.zone_of(i) != lost_zone]
    scatter = [int(i) for i in rng.choice(others, size=8, replace=False)]
    records, decided = [], []
    t0 = time.perf_counter()
    for victims in (scatter, zone_victims):
        sim.crash(np.array(victims))
        rec = sim.run_until_decision(max_rounds=32, batch=16)
        assert rec is not None
        decided.append(rec)
        records.append(_record_digest(rec))
        fingerprints.append(int(sim.global_fingerprint()))
    wall = time.perf_counter() - t0
    rows = _hierarchy_rows(sim)
    incremental = sim.global_fingerprint()
    for state in sim.hierarchy_rows():
        sim._hierarchy_recompute_cell(state.cell)
    run = {
        "lost_zone": lost_zone, "leader": leader, "scatter": scatter, "records": records,
        "rows": rows, "cells": {str(r[0]): r[2] for r in rows},
        "parent_rounds": int(sim.parent_rounds), "global_fingerprints": fingerprints,
        "fingerprint_ok": bool(incremental == sim.global_fingerprint()),
        "virtual_ms": int(sim.virtual_ms),
    }
    if result is not None:
        run["scenario"] = dict(result(
            sim, seed=seed, zones=zones, per_zone=per_zone, lost_zone=lost_zone,
            leader=leader, scatter=scatter, zone_victims=zone_victims, records=decided,
            wall=wall), scenario="hierarchy-zone-churn")
    return run


def planes_golden_runs(device, result=None):
    """The three runs of ``tests/golden/torch_planes.json`` on the port, on
    ``device``: the bench's serving dimension, the sweep's placement point
    and hierarchy-zone-churn. With ``result`` (``zone_churn_run``'s), the
    zone churn also carries the registry scenario's record and, under
    "launches", its kernel launches."""
    from rapid_tpu_torch.hierarchy.parent import cell_leaders
    from rapid_tpu_torch.settings import SLOSettings
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig
    from rapid_tpu_torch.sim.topology import LatencyTopology
    from rapid_tpu_torch.slo import OpenLoopGenerator
    from rapid_tpu_torch.types import Endpoint

    runs = {
        "serving_dimension": serving_dimension_run(Simulator, SLOSettings, OpenLoopGenerator,
                                                   device=device),
        "sweep_point": sweep_point_run(device=device),
    }
    before = dict(kernels.LAUNCHES)
    runs["zone_churn"] = zone_churn_run(Simulator, SimConfig, LatencyTopology, Endpoint,
                                        cell_leaders, **ZONE_CHURN, result=result, device=device)
    if result is not None:
        runs["zone_churn"]["launches"] = _diff(dict(kernels.LAUNCHES), before)
    return runs


def _golden_misses(got, want, path=""):
    """Where ``got`` differs from ``want`` (JSON-ready data), as paths."""
    if isinstance(want, dict) and isinstance(got, dict):
        misses = [f"{path}/{k}: missing" for k in want if k not in got]
        for k in want:
            if k in got:
                misses += _golden_misses(got[k], want[k], f"{path}/{k}")
        return misses
    if isinstance(want, list) and isinstance(got, (list, tuple)):
        if len(got) != len(want):
            return [f"{path}: {len(got)} items, want {len(want)}"]
        return [m for i, (g, w) in enumerate(zip(got, want)) for m in _golden_misses(g, w, f"{path}[{i}]")]
    return [] if got == want else [f"{path}: {got!r}, want {want!r}"]


def planes_golden_check(device, runs=None):
    """The port's runs (``runs``, else ``planes_golden_runs(device)``'s)
    against ``tests/golden/torch_planes.json``, exactly. Returns {run:
    misses}."""
    with open(PLANES_GOLDEN) as f:
        want = json.load(f)["runs"]
    got = json.loads(json.dumps(runs if runs is not None else planes_golden_runs(device)))
    return {name: _golden_misses(got[name], want[name]) for name in want}


# the bench's gray-detection dimension (bench.py GRAY_*, run_gray_detection_dimension)
GRAY_N_NODES = 64
GRAY_DELAY_MS = 5_000
GRAY_CONFIRM = 3
GRAY_WARMUP = 3
GRAY_WINDOWS = {
    "gray_slow_node": ((3_000, None),),
    "gray_flapping": ((3_000, 9_000), (15_000, 21_000), (27_000, 33_000)),
}
GRAY_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "torch_gray.json")


def gray_dimension_run(faults, Simulator, SimConfig, LatencyTopology, seed=SEED, **sim_kw):
    """The bench's gray-detection dimension as written
    (``bench.run_gray_detection_dimension``): 64 members on a two-region
    topology, one slow node (``slow_node`` at 5 s, gray for good or
    flapping), replayed through ``faults.replay_on_simulator`` with the
    static counter and with the adaptive streak (``fd_gray_confirm``).
    Takes either package's fault plane and classes, so
    ``tests/golden/generate_torch_gray.py`` records the JAX package's run
    and the port's is held to it. Returns each replay's records and
    detection time, and each scenario's speedup, as JSON-ready data."""
    topo = LatencyTopology(racks=4, zones=2, regions=2, rack_rtt_ms=0, zone_rtt_ms=0,
                           region_rtt_ms=0, inter_region_rtt_ms=200)
    out = {}
    for scenario, windows in GRAY_WINDOWS.items():
        entry = {}
        for mode, confirm in (("static", 0), ("adaptive", GRAY_CONFIRM)):
            config = SimConfig(capacity=GRAY_N_NODES, groups=2, max_delivery_delay=2,
                               fd_gray_confirm=confirm, fd_gray_warmup=GRAY_WARMUP)
            sim = Simulator(GRAY_N_NODES, config=config, seed=seed, **sim_kw)
            endpoint_of = {slot: ep for ep, slot in faults.endpoint_slots(sim).items()}
            victim = GRAY_N_NODES - 1
            plan = faults.FaultPlan(seed=seed).slow_node(
                endpoint_of[victim], GRAY_DELAY_MS, windows=windows).with_topology(topo)
            epoch = sim.virtual_ms
            records = faults.replay_on_simulator(sim, plan, duration_ms=45_000)
            assert records and [int(c) for c in records[0].cut] == [victim], (
                f"{scenario}/{mode}: cut parity")
            entry[mode] = {"records": [_record_digest(r) for r in records],
                           "detect_ms": int(records[0].virtual_time_ms - epoch - windows[0][0]),
                           "virtual_ms": int(sim.virtual_ms)}
        entry["speedup"] = round(entry["static"]["detect_ms"]
                                 / max(entry["adaptive"]["detect_ms"], 1), 2)
        out[scenario] = entry
    return out


def gray_golden_check(device):
    """The port's gray dimension (its own ``faults``) against
    ``tests/golden/torch_gray.json``, exactly; returns the run and its
    misses."""
    from rapid_tpu_torch import faults
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.sim.engine import SimConfig
    from rapid_tpu_torch.sim.topology import LatencyTopology

    with open(GRAY_GOLDEN) as f:
        want = json.load(f)["run"]
    got = json.loads(json.dumps(gray_dimension_run(faults, Simulator, SimConfig,
                                                   LatencyTopology, device=device)))
    return got, _golden_misses(got, want)


def _topr_inputs(rng, rows, cols, weights, inactive, device):
    part = torch.from_numpy(rng.integers(0, 2**32, rows, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(device)
    w = rng.integers(weights[0], weights[1] + 1, cols).astype(np.int32)
    inst = torch.from_numpy(rng.integers(0, 2**32, (int(w.max()), cols), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(device)
    active = torch.from_numpy(rng.random(cols) >= inactive).to(device)
    return part, inst, torch.from_numpy(w).to(device), active


def _topr_bound(rows, weights, active, replicas, cols=None, prior_rows=0):
    """(bound ms, "bytes" or "operations"): the operations this run's
    candidates need over the INT32 rate, against each input read once and
    the output written once over HBM's rate."""
    w = weights.to(torch.int64)
    if cols is None:
        per_row = int((w * TOPR_OPS_PER_INSTANCE + TOPR_OPS_PER_PAIR)[active].sum())
        scanned = weights.numel()
    else:
        per_row = int((w[cols.long()] * TOPR_OPS_PER_INSTANCE + TOPR_OPS_PER_PAIR).sum())
        scanned = cols.numel()
    ops = rows * per_row
    n_inst = int(w.max())
    nbytes = (4 * rows + 4 * n_inst * weights.numel() + 4 * scanned
              + (active.numel() if cols is None else 4 * cols.numel())
              + 8 * replicas * prior_rows + 8 * replicas * rows)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _events_ms(fn, iters):
    """Device ms of one call of ``fn``, over ``iters`` calls timed with CUDA
    events (the plain version's Python loop cannot be graph-captured whole)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _topr_parent(fn, part, inst, w, active, r, cols=None, prior=None):
    """The parent commit's ``placement_topr`` through its own C entry
    (``fn``), as that commit's wrapper called it."""
    out = torch.empty((part.shape[0], 2 * r), dtype=torch.int32, device=part.device)
    err = fn(part.data_ptr(), part.shape[0], inst.data_ptr(), inst.shape[1], inst.shape[0],
             w.data_ptr(), active.data_ptr() if cols is None else None,
             None if cols is None else cols.data_ptr(), 0 if cols is None else cols.shape[0],
             None if prior is None else prior.data_ptr(), out.data_ptr(), r,
             torch.cuda.current_stream(part.device).cuda_stream)
    assert err == 0, f"the parent commit's placement_topr: CUDA error {err}"
    return out


def topr_phase(device, card, view_change, parent=None):
    """``placement_topr`` against its plain version on the card, bit for
    bit, at the full-width shapes (``TOPR_CASES``, ``TOPR_MERGE``) and at the
    planes path's own view change (``view_change``: its affected rows, the
    map's keys and the new active set): cold (input sets rotated past 2x the
    L2) and hot device time, its bound, the plain version's time, and the
    launch plan. With ``parent`` (the parent commit's entry,
    ``finish_topr_builds``), that kernel is held to the plain version too and
    timed beside the kernel in turns (kernel, parent, parent, kernel), cold
    and hot. No single PyTorch call computes this function."""
    import dataclasses

    from rapid_tpu_torch.placement import device as pdev

    out = {}
    rng = np.random.default_rng(SEED + 9900)
    cases = [(name, rows, cols, r, w, inactive, None, None)
             for name, rows, cols, r, w, inactive in TOPR_CASES]
    name, rows, cols, r, added = TOPR_MERGE
    cases.append((name, rows, cols, r, (1, 1), 0.01, added, None))
    cases.append((TOPR_VIEW_CHANGE, int(view_change["part"].shape[0]),
                  int(view_change["weights"].shape[0]), view_change["replicas"], (1, 1),
                  1 - float(view_change["active"].float().mean()), None, view_change))
    versions = {"kernel": lambda p, i, ww, a, r, **k: pdev.placement_topr(
        p, i, ww, None if k else a, r, **k)}
    if parent is not None:
        versions["parent"] = lambda p, i, ww, a, r, **k: _topr_parent(parent, p, i, ww, a, r, **k)
    for name, rows, cols, r, weights, inactive, added, given in cases:
        if given is None:
            part, inst, w, active = _topr_inputs(rng, rows, cols, weights, inactive, device)
        else:
            part, inst, w, active = (given[k] for k in ("part", "inst", "weights", "active"))
        kw = {}
        if added is not None:
            prior = pdev.placement_topr(part, inst, w, active, r)
            merge_cols = torch.from_numpy(np.sort(rng.choice(cols, added, replace=False))
                                          .astype(np.int32)).to(device)
            kw = {"cols": merge_cols, "prior": prior}
        want = pdev.placement_topr_plain(part, inst, w, None if kw else active, r, **kw)
        errs = {}
        for version, fn in versions.items():
            got = fn(part, inst, w, active, r, **kw)
            torch.cuda.synchronize()
            errs[version] = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            assert errs[version] == 0 and torch.equal(got, want), (
                f"placement_topr ({version}) disagrees: {name}")
        per_set = 4 * (part.numel() + inst.numel() + w.numel()) + active.numel()
        n_sets = max(2, TOPR_COLD_BYTES // per_set + 1)
        sets = [_topr_inputs(rng, rows, cols, weights, inactive, device) for _ in range(n_sets)]
        times = {version: {"cold": [], "hot": []} for version in versions}
        order = ["kernel", "parent", "parent", "kernel"] if parent is not None else ["kernel"]
        for version in order:
            fn = versions[version]
            times[version]["cold"].append(_time_ms(
                [lambda s=s_, fn=fn: fn(*s, r, **kw) for s_ in sets], reps=len(sets), iters=5))
            times[version]["hot"].append(_time_ms(
                lambda fn=fn: fn(part, inst, w, active, r, **kw), reps=8, iters=5))
        plain_ms = _events_ms(lambda: pdev.placement_topr_plain(
            part, inst, w, None if kw else active, r, **kw), 2)
        bound_ms, bound_by = _topr_bound(
            rows, w, active, r, kw.get("cols"), rows if kw else 0)
        plan = pdev.topr_plan(rows, kw["cols"].numel() if kw else cols, r, inst.shape[0],
                              bool(kw))
        mean = {v: {k: statistics.fmean(t) for k, t in ts.items()} for v, ts in times.items()}
        out[name] = {"shape": [rows, cols], "replicas": r, "max_abs_err": max(errs.values()),
                     "ms": mean["kernel"]["cold"], "hot_ms": mean["kernel"]["hot"],
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "plan": dict(dataclasses.asdict(plan), grid=plan.grid), "turns": times}
        line = (f"placement_topr, {name}: bit-identical to plain (tolerance 0), cold "
                f"{mean['kernel']['cold'] * 1e3:.1f} us ({n_sets} input sets), hot "
                f"{mean['kernel']['hot'] * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}, "
                f"{100 * bound_ms / mean['kernel']['cold']:.0f}% of it cold)")
        if parent is not None:
            out[name]["parent_ms"] = mean["parent"]["cold"]
            out[name]["parent_hot_ms"] = mean["parent"]["hot"]
            parent_ms = mean["parent"]
            line += (f"; the parent commit's kernel in turns, also bit-identical: cold "
                     f"{parent_ms['cold'] * 1e3:.1f} us, hot {parent_ms['hot'] * 1e3:.1f} us "
                     f"({100 * bound_ms / parent_ms['cold']:.0f}%); turns kernel/parent cold "
                     f"{[round(t * 1e3, 1) for t in times['kernel']['cold']]} / "
                     f"{[round(t * 1e3, 1) for t in times['parent']['cold']]} us")
        else:
            line += "; the parent commit's kernel: not timed (no archive under build/parent)"
        print(f"{line}; plain {plain_ms:.2f} ms; plan {rows} rows: columns split over "
              f"{plan.col_split} warps, {plan.slices} slices, {plan.tile_cols}-column tiles, "
              f"grid {plan.grid}, "
              f"{plan.smem_bytes} B shared; library: none ({card})", flush=True)
    return out


def planes_path(device, card, n=N_NODES, seed=SEED):
    """The planes on the full-width path: ``Simulator(100_000)`` with
    placement (8192 x 3, built by ``placement_topr``), handoff, serving, the
    SLO plane, durability and an 8-cell hierarchy; the bench's serving
    traffic steady, through a crash of 1% (the closed form) and after the
    view; then ``restart_slot`` of a live slot. Holds every plane's
    invariant, the configuration id against a plain simulator's, and the
    decision's syncs (the debug mode's count equal to the labelled ones).
    Launch counts are reset just before the path and read just after.
    Returns the result and the view change's ``placement_topr`` inputs (its
    affected rows' keys, the map's instance keys and weights, the new active
    set) for ``topr_phase``."""
    from rapid_tpu_torch.placement.device import DevicePlacement
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.settings import SLOSettings
    from rapid_tpu_torch.sim import kernels
    from rapid_tpu_torch.sim.driver import Simulator
    from rapid_tpu_torch.slo import OpenLoopGenerator

    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        return result

    rng = np.random.default_rng(seed + 9100)
    rss_before = _rss_mib()
    sim = timed("Simulator", lambda: Simulator(n, seed=seed, device=device).ready())
    kernels.reset_launches()
    syncs_before = dict(jitwatch.sync_counts())
    timed("enable_placement", lambda: sim.enable_placement(
        partitions=PLANES_PARTITIONS, replicas=PLANES_REPLICAS))
    timed("enable_handoff", sim.enable_handoff)
    timed("enable_serving", sim.enable_serving)
    plane = timed("enable_slo", lambda: sim.enable_slo(
        SLOSettings(enabled=True, window_scale=SERVING_SLO_WINDOW_SCALE)))
    timed("enable_durability", sim.enable_durability)
    timed("enable_hierarchy", lambda: sim.enable_hierarchy(cells=PLANES_CELLS))
    keys = [b"bench-key-%04d" % i for i in range(SERVING_KEYS)]
    for i, key in enumerate(keys):
        assert sim.serving_put(key, b"seed-%d" % i).status == 0, "preload write failed"
    gen = OpenLoopGenerator(SERVING_RATE_PER_S, keys, put_fraction=SERVING_PUT_FRACTION,
                            seed=seed, zipf_s=SERVING_ZIPF_S, clients=SERVING_CLIENTS)
    windows = {}
    windows["steady"] = timed("window steady", lambda: drive_open_loop(sim, gen, 300))
    victims = np.sort(rng.choice(n, n // 100, replace=False))
    before_assign = sim.placement.assign.copy()
    sim.crash(victims)
    windows["view_change_window"] = timed("window view_change_window",
                                          lambda: drive_open_loop(sim, gen, 150))
    decided = []
    labelled = dict(jitwatch.sync_counts())
    t0 = time.perf_counter()
    debug_syncs = _count_syncs(lambda: sim.run_until_decision(max_rounds=16, batch=16), decided)
    torch.cuda.synchronize()
    walls["view change, planes on"] = (time.perf_counter() - t0) * 1e3
    decision_syncs = _diff(jitwatch.sync_counts(), labelled)
    rec = decided[0]
    assert rec is not None and np.array_equal(np.sort(rec.cut), victims), "planes: cut != victims"
    windows["post_view"] = timed("window post_view", lambda: drive_open_loop(sim, gen, 150))
    lost = _lost_acked(sim)
    # restart a live replica of the first key's partition: it holds writes
    slot = sim._serving_row(keys[0])[2][0]
    pending = sim.durable_pending(slot)
    replayed = timed("restart_slot", lambda: sim.restart_slot(slot))
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    syncs = _diff(jitwatch.sync_counts(), syncs_before)

    # the invariants
    diff = sim.placement_diffs[0]
    expected = np.flatnonzero(np.isin(before_assign, victims).any(axis=1))
    assert len(sim.placement_diffs) == 1
    assert np.array_equal(np.sort(diff.partitions_moved), expected), "moved != rows meeting victims"
    assert not np.isin(sim.placement.assign, victims).any(), "a victim is left in the map"
    fresh = DevicePlacement(sim.placement.config, sim.cluster.hostnames, sim.cluster.host_lengths,
                            sim.cluster.ports, device=device)
    fresh.build(sim.active)
    assert fresh.version == sim.placement.version, "map version != a fresh build's"
    assert np.array_equal(fresh.assign, sim.placement.assign)
    started = sim.metrics.get("handoff.sessions_started")
    completed = sim.metrics.get("handoff.sessions_completed")
    assert started > 0 and completed == started, (completed, started)
    assert lost == 0, f"{lost} acked writes lost"
    incremental = sim.global_fingerprint()
    for state in sim.hierarchy_rows():
        sim._hierarchy_recompute_cell(state.cell)
    assert incremental == sim.global_fingerprint(), "hierarchy fingerprint != recompute"
    assert pending > 0 and replayed == pending, (replayed, pending)
    assert launches.get("placement_topr", 0) >= 2, launches
    assert decision_syncs.get("placement.assign") == 1, decision_syncs
    assert debug_syncs == sum(decision_syncs.values()), (debug_syncs, decision_syncs)
    plain = Simulator(n, seed=seed, device=device).ready()
    plain.crash(victims)
    t0 = time.perf_counter()
    plain_rec = plain.run_until_decision(max_rounds=16, batch=16)
    plain.ready()
    walls["view change, planes off"] = (time.perf_counter() - t0) * 1e3
    assert plain_rec.configuration_id == rec.configuration_id, "configuration id != plain"
    # the view change's placement_topr call, for topr_phase: its rows, the
    # map's keys and the new active set
    placement = sim.placement
    view_change = {
        "part": placement._part_dev.index_select(0, torch.from_numpy(expected).to(device)),
        "inst": placement._inst_dev, "weights": placement._weights_dev,
        "active": torch.from_numpy(placement.active).to(device), "replicas": placement.replicas,
    }

    summary = plane.summary(sim.virtual_ms)
    result = {
        "walls_ms": walls, "launches": launches, "syncs": syncs,
        "decision_syncs": decision_syncs, "debug_mode_syncs": debug_syncs,
        "moved": int(diff.moved), "handoff_sessions": int(started),
        "bytes_moved": int(sim.metrics.get("handoff.bytes_moved")),
        "reconciled_replicas": int(sim.metrics.get("serving.reconciled_replicas")),
        "parent_rounds": int(sim.parent_rounds), "replayed": int(replayed),
        "acked": len(sim.serving_acked), "virtual_ms": int(sim.virtual_ms),
        "configuration_id": int(rec.configuration_id),
        "windows": {k: {"ops": len(v["statuses"]), "elapsed_ms": v["elapsed_ms"],
                        "p99_ms": sorted(v["latencies_ms"])[int(0.99 * (len(v["latencies_ms"]) - 1))]}
                    for k, v in windows.items()},
        "slo_availability": {k: v["availability"] for k, v in summary.items()},
        "host_rss_mib": _rss_mib(), "host_rss_growth_mib": _rss_mib() - rss_before,
    }
    print(f"planes, full width: {n} members, {len(victims)} crashed, cut ok, config id "
          f"{rec.configuration_id} == a plain simulator's, {diff.moved} partitions moved == the rows "
          f"meeting the victims, no victim left, version == a fresh build's; handoff {completed}/"
          f"{started} sessions; 0 of {len(sim.serving_acked)} acked writes lost; hierarchy "
          f"fingerprint == recompute ({sim.parent_rounds} parent round); restart_slot({slot}) "
          f"replayed {replayed} == durable_pending ({card})", flush=True)
    print(f"planes, walls ms: {json.dumps({k: round(v, 1) for k, v in walls.items()})} ({card})",
          flush=True)
    print(f"planes, the decision's syncs {decision_syncs} (debug mode: {debug_syncs}); the path's "
          f"syncs {syncs}; launches {launches}; host RSS {result['host_rss_mib']:.0f} MiB, "
          f"{result['host_rss_growth_mib']:.0f} MiB of it since before the simulator ({card})",
          flush=True)
    return result, view_change


def planes_host_memory(device, card, n=N_NODES, seed=SEED):
    """The host memory the planes hold at full width: a fresh
    ``Simulator(n)`` with every plane enabled as in ``planes_path``, the
    Python and numpy allocations of the ``enable_*`` calls traced by
    ``tracemalloc`` (which slows them, so no wall is taken here). Returns
    MiB held after each call and the peak."""
    import tracemalloc

    from rapid_tpu_torch.settings import SLOSettings
    from rapid_tpu_torch.sim.driver import Simulator

    sim = Simulator(n, seed=seed, device=device).ready()
    held = {}
    tracemalloc.start()
    try:
        for name, fn in (
                ("enable_placement", lambda: sim.enable_placement(
                    partitions=PLANES_PARTITIONS, replicas=PLANES_REPLICAS)),
                ("enable_handoff", sim.enable_handoff),
                ("enable_serving", sim.enable_serving),
                ("enable_slo", lambda: sim.enable_slo(
                    SLOSettings(enabled=True, window_scale=SERVING_SLO_WINDOW_SCALE))),
                ("enable_durability", sim.enable_durability),
                ("enable_hierarchy", lambda: sim.enable_hierarchy(cells=PLANES_CELLS))):
            fn()
            held[name] = tracemalloc.get_traced_memory()[0] / 2**20
        peak = tracemalloc.get_traced_memory()[1] / 2**20
    finally:
        tracemalloc.stop()
    print(f"planes, host memory at {n} members (tracemalloc, MiB held after each enable): "
          f"{json.dumps({k: round(v, 1) for k, v in held.items()})}, peak {peak:.1f} ({card})",
          flush=True)
    return {"held_mib": held, "peak_mib": peak}


def _rss_mib():
    """This process's resident host memory, from /proc (Linux)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


# --- the protocol plane's live engines: a real member's durable store, handoff,
# serving and hierarchy planes, at the size the bench gives its serving
# deployment (bench.py SERVING_*, HIER_CELLS, RECOVERY_*) ---------------------
LIVE_PLACEMENT = {"partitions": SERVING_PARTITIONS, "replicas": 3, "seed": 5}
LIVE_SEED = 5
LIVE_BASE_PORT = 9_000
HIER_CELLS = 8
# the tier-1 twin of the phase (tests/test_torch_live_planes.py): the same
# script at 8 members, 2 cells and a fifth of the traffic
LIVE_REDUCED = {"n_nodes": 8, "cells": 2,
                "ops": (("steady", 60), ("view_change_window", 30), ("post_view", 30))}
RECOVERY_LOG_RECORDS = (256, 1024)
RECOVERY_SNAPSHOT_EVERY = (0, 256)  # 0: no snapshot, the whole log replays
RECOVERY_PARTITIONS = 32
RECOVERY_VALUE_BYTES = 512
LIVE_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "torch_live_planes.json")
LIVE_MODULES = ("cluster", "durability", "events", "handoff.store", "hierarchy.cells",
                "hierarchy.parent", "messaging.inprocess", "monitoring.static_fd",
                "runtime.scheduler", "serving.kv", "settings", "slo", "types")


def live_modules(package):
    """The modules of ``package`` the live-planes phase drives, as
    attributes (dots become underscores): the card runs the port's
    (``"rapid_tpu_torch"``), ``tests/golden/generate_torch_live_planes.py``
    the JAX package's."""
    import importlib
    import types as pytypes

    ns = pytypes.SimpleNamespace(name=package)
    for module in LIVE_MODULES:
        setattr(ns, module.replace(".", "_"), importlib.import_module(f"{package}.{module}"))
    return ns


class LiveHarness:
    """Members of package ``P`` on one ``InProcessNetwork`` and one
    ``VirtualScheduler``, built as ``tests/harness.py`` builds them (static
    failure detector over a blacklist, one rng a member drawn from the
    harness's seed), recording every member's installed configuration ids."""

    def __init__(self, P, seed, settings):
        self.P = P
        self.scheduler = P.runtime_scheduler.VirtualScheduler()
        self.network = P.messaging_inprocess.InProcessNetwork(self.scheduler)
        self.rng = random.Random(seed)
        self.settings = settings
        self.blacklist = set()
        self.instances = {}
        self.config_ids = []  # every distinct configuration id, first install order
        self.nemesis = None

    def with_faults(self, plan):
        """Arm ``plan`` on package ``P``'s ``Nemesis`` (a registry of its
        own): every member built afterwards has its client, server and
        scheduler wrapped, as ``tests/harness.py``'s ``with_faults`` does."""
        self.nemesis = self.P.faults.Nemesis(plan, self.scheduler,
                                             metrics=self.P.observability.Metrics())
        return self

    def addr(self, i):
        return self.P.types.Endpoint.from_parts("127.0.0.1", LIVE_BASE_PORT + i)

    def _view_change(self, configuration_id, _changes):
        if configuration_id not in self.config_ids:
            self.config_ids.append(configuration_id)

    def builder(self, i, placement=None, serving=False, durability=None):
        P, addr = self.P, self.addr(i)
        client = P.messaging_inprocess.InProcessClient(addr, self.network, self.settings)
        server = P.messaging_inprocess.InProcessServer(addr, self.network)
        scheduler = self.scheduler
        if self.nemesis is not None:
            client = self.nemesis.client(client, address=addr, settings=self.settings)
            server = self.nemesis.server(server, addr)
            scheduler = self.nemesis.scheduler_for(addr)
        builder = (P.cluster.ClusterBuilder(addr)
                   .set_messaging_client_and_server(client, server)
                   .use_scheduler(scheduler).use_settings(self.settings)
                   .use_rng(random.Random(self.rng.getrandbits(64)))
                   .set_edge_failure_detector_factory(
                       P.monitoring_static_fd.StaticFailureDetectorFactory(self.blacklist))
                   .add_subscription(P.events.ClusterEvents.VIEW_CHANGE, self._view_change))
        if placement:
            builder.use_placement(**placement)
        if serving:
            builder.use_serving()
        if durability is not None:
            builder.use_durability(durability)
        return builder

    def start(self, i, **kw):
        cluster = self.builder(i, **kw).start()
        self.instances[cluster.listen_address] = cluster
        return cluster

    def join_all(self, joins, timeout_ms=1_200_000):
        """``joins``: (member, seed member, builder keywords); all race at once."""
        promises = [self.builder(i, **kw).join_async(self.addr(seed)) for i, seed, kw in joins]
        assert self.scheduler.run_until(lambda: all(p.done() for p in promises),
                                        timeout_ms=timeout_ms), "joins timed out (virtual)"
        for p in promises:
            assert p.exception() is None, f"join failed: {p.exception()}"
            self.instances[p.peek().listen_address] = p.peek()

    def fail(self, endpoints):
        for ep in endpoints:
            self.blacklist.add(ep)
            cluster = self.instances.pop(ep, None)
            if cluster is not None:
                cluster.shutdown()

    def agree(self, members, timeout_ms=1_200_000):
        """Every member in ``members`` holds the same member list, of their
        number; returns their one configuration id."""
        def converged():
            lists = [self.instances[ep].get_memberlist() for ep in members]
            return all(len(m) == len(members) and m == lists[0] for m in lists)

        assert self.scheduler.run_until(converged, timeout_ms=timeout_ms, poll_ms=100), (
            f"no agreement on {len(members)} members")
        ids = {self.instances[ep].get_current_configuration_id() for ep in members}
        assert len(ids) == 1, f"diverging configuration ids {ids}"
        return ids.pop()

    def live(self):
        return sorted(self.instances, key=str)

    def shutdown(self):
        for cluster in list(self.instances.values()):
            cluster.shutdown()
        self.instances.clear()


def _quantiles(latencies):
    """p50 and p99 (nearest rank) of ``latencies``."""
    ordered = sorted(latencies)
    return {f"p{q}_ms": ordered[min(len(ordered) - 1, q * len(ordered) // 100)]
            for q in (50, 99)}


def live_open_loop(h, gen, n_ops, acked, timeout_ms=600_000):
    """One open-loop window on live members: ``n_ops`` arrivals of ``gen``
    (rebased to the scheduler's clock), each sent at its arrival time
    through the live member ``client % members`` routes it to, whatever is
    still in flight. Acked puts raise ``acked[key]`` to their version.
    Returns the statuses, latencies (virtual ms, arrival to answer) and the
    window's virtual span."""
    OK = h.P.types.PutAck.STATUS_OK
    gen.rebase(h.scheduler.now_ms())
    t0 = h.scheduler.now_ms()
    arrivals = gen.arrivals(n_ops)
    results = [None] * n_ops

    def send(i, a):
        routers = h.live()
        cluster = h.instances[routers[a.client % len(routers)]]
        promise = (cluster.serving_put(a.key, a.value) if a.op == "put"
                   else cluster.serving_get(a.key))

        def answered(p):
            ack = p.peek() if p.exception() is None else None
            status = -1 if ack is None else int(ack.status)
            results[i] = (status, h.scheduler.now_ms() - a.at_ms)
            if a.op == "put" and status == OK:
                acked[a.key] = max(acked.get(a.key, 0), int(ack.version))

        promise.add_callback(answered)

    for i, a in enumerate(arrivals):
        h.scheduler.schedule(max(0, a.at_ms - t0), lambda i=i, a=a: send(i, a))
    assert h.scheduler.run_until(lambda: all(r is not None for r in results),
                                 timeout_ms=timeout_ms), "open-loop window never drained"
    latencies = [float(lat) for _s, lat in results]
    return dict({"ops": n_ops, "statuses": [s for s, _ in results],
                 "ok": sum(s == OK for s, _ in results),
                 "virtual_ms": int(h.scheduler.now_ms() - t0)}, **_quantiles(latencies))


def _until_ok(h, call, attempts=300):
    """A client's retry loop: send again until the answer is OK (virtual time
    runs on each attempt, so detection and handoff land)."""
    OK = h.P.types.PutAck.STATUS_OK
    for _ in range(attempts):
        promise = call()
        assert h.scheduler.run_until(promise.done, timeout_ms=600_000)
        if promise.exception() is None and promise.peek().status == OK:
            return promise.peek()
    raise AssertionError("a serving op never answered OK")


def _drain_handoff(h):
    assert h.scheduler.run_until(
        lambda: all(c.get_handoff_status()[0] == 0 for c in h.instances.values()),
        timeout_ms=1_200_000), "handoff sessions never drained"


def live_serving_run(P, root, n_nodes=SERVING_N_NODES, ops=SERVING_OPS, seed=LIVE_SEED):
    """Part (a): ``n_nodes`` members of package ``P`` (``ClusterBuilder`` on
    ``InProcessNetwork`` and ``VirtualScheduler``), placement 256 x 3, each
    on its own ``DurablePartitionStore`` under ``root`` with serving on,
    bootstrapped by joins through the seed, one at a time. The bench's serving
    traffic (``OpenLoopGenerator``: 64 keys, zipf 1.1, 20% puts, 600/s) in
    three windows: steady, the churn window after the member leading the
    hottest key's partition crashes (power loss: its store crashed too), and
    after the view; then the victim restarts at its old address, recovers
    from its WAL and rejoins. Checks: every acked write reads back at or
    above its version from a survivor, every handoff session completes,
    every partition's replicas hold equal fingerprints, every member has the
    same configuration id and placement version, and the restarted member's
    status reports the ``replayed_records`` its store does. Returns the
    run's outcome (JSON-ready) and its host walls apart."""
    D = P.durability
    settings = P.settings.Settings(durability=P.settings.DurabilitySettings(
        enabled=True, fsync_policy=D.FSYNC_NEVER))
    h = LiveHarness(P, seed, settings)
    dirs = {i: os.path.join(root, f"member{i}") for i in range(n_nodes)}

    def kw(i):
        return {"placement": LIVE_PLACEMENT, "serving": True, "durability": dirs[i]}

    walls = {}
    try:
        t0 = time.perf_counter()
        h.start(0, **kw(0))
        for i in range(1, n_nodes):
            # one at a time: a row whose every replica joined in one view
            # change has no copy to sync from, and its leader answers RETRY
            # until another view moves it (the JAX engine alike)
            h.join_all([(i, 0, kw(i))])
        h.agree(h.live())
        _drain_handoff(h)
        walls["bootstrap_ms"] = (time.perf_counter() - t0) * 1e3
        bootstrap_virtual = h.scheduler.now_ms()

        keys = [b"bench-key-%04d" % i for i in range(SERVING_KEYS)]
        acked = {}
        router = h.instances[h.addr(0)]
        for i, key in enumerate(keys):
            acked[key] = int(_until_ok(h, lambda k=key, i=i: router.serving_put(
                k, b"seed-%d" % i)).version)
        gen = P.slo.OpenLoopGenerator(SERVING_RATE_PER_S, keys,
                                      put_fraction=SERVING_PUT_FRACTION, seed=seed,
                                      zipf_s=SERVING_ZIPF_S, clients=SERVING_CLIENTS)
        windows = {}
        t0 = time.perf_counter()
        windows["steady"] = live_open_loop(h, gen, ops[0][1], acked)
        walls["steady_ms"] = (time.perf_counter() - t0) * 1e3

        pmap = router.get_placement_map()
        hot = P.serving_kv.partition_of(keys[0], len(pmap.assignments))
        victim = pmap.assignments[hot][0]
        victim_i = int(victim.port) - LIVE_BASE_PORT
        old_identity = h.instances[victim].get_partition_store().node_id
        h.instances[victim].get_partition_store().crash()
        t0 = time.perf_counter()
        crash_virtual = h.scheduler.now_ms()
        h.fail([victim])
        windows["view_change_window"] = live_open_loop(h, gen, ops[1][1], acked)
        config_after_crash = h.agree(h.live())
        walls["crash_to_agreement_ms"] = (time.perf_counter() - t0) * 1e3
        crash_to_agreement_virtual = h.scheduler.now_ms() - crash_virtual
        t0 = time.perf_counter()
        windows["post_view"] = live_open_loop(h, gen, ops[2][1], acked)
        walls["post_view_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        h.blacklist.discard(victim)
        seed_i = int(h.live()[0].port) - LIVE_BASE_PORT
        h.join_all([(victim_i, seed_i, kw(victim_i))])
        final_config = h.agree(h.live())
        _drain_handoff(h)
        walls["restart_ms"] = (time.perf_counter() - t0) * 1e3

        revived = h.instances[victim]
        store = revived.get_partition_store()
        replayed = int(store.durability_stats()["replayed_records"])
        assert revived.get_cluster_status().durability_replayed == replayed > 0, (
            "the restarted member's status and store disagree on replayed records")

        survivors = [ep for ep in h.live() if ep != victim]

        def lost_writes():
            lost = []
            for j, key in enumerate(sorted(acked)):
                reader = h.instances[survivors[j % len(survivors)]]
                back = _until_ok(h, lambda k=key, r=reader: r.serving_get(k))
                if back.version < acked[key]:
                    lost.append(key.decode())
            return lost

        lost = lost_writes()
        assert not lost, f"acked writes read back below their version: {lost}"

        sessions = {}
        for name in ("handoff.sessions_started", "handoff.sessions_completed",
                     "handoff.sessions_failed"):
            sessions[name] = sum(int(c._membership_service.metrics.get(name))  # noqa: SLF001
                                 for c in h.instances.values())
        in_flight = sum(c.get_handoff_status()[0] for c in h.instances.values())
        assert in_flight == 0 and sessions["handoff.sessions_failed"] == 0 and (
            sessions["handoff.sessions_started"] == sessions["handoff.sessions_completed"]), (
            f"handoff sessions incomplete: {sessions}, {in_flight} in flight")

        maps = {ep: c.get_placement_map() for ep, c in h.instances.items()}
        versions = {m.version for m in maps.values()}
        ids = {c.get_current_configuration_id() for c in h.instances.values()}
        assert len(versions) == 1 and len(ids) == 1, (versions, ids)
        rows = maps[victim].assignments

        def replica_prints():
            """Each partition's fingerprint on its replicas (None where none
            holds it yet), or False where they differ; a replica that
            holds nothing stands beside an empty key space only."""
            out = []
            for p, row in enumerate(rows):
                stores = [h.instances[ep].get_partition_store() for ep in row]
                holders = [s for s in stores if s.get(p) is not None]
                prints = {s.fingerprint(p) for s in holders}
                same = len(prints) <= 1 and (len(holders) == len(stores) or not any(
                    P.serving_kv.decode_kv(s.get(p)) for s in holders))
                out.append((prints.pop() if prints else None) if same else False)
            return out

        # the restarted member rejoins with what its log held: keys written
        # while it was down stay stale on it until a write refreshes them
        # (the engine re-replicates no merged state across a row), so every
        # key is written once more, as tests/test_durability.py's recovery
        # case does, and the replicas must then agree
        stale_before_refresh = [p for p, fp in enumerate(replica_prints()) if fp is False]
        for i, key in enumerate(keys):
            acked[key] = max(acked[key], int(_until_ok(h, lambda k=key, i=i: h.instances[
                survivors[i % len(survivors)]].serving_put(k, b"refresh-%d" % i)).version))
        h.scheduler.run_for(2_000)
        fingerprints = replica_prints()
        differ = [p for p, fp in enumerate(fingerprints) if fp is False]
        assert not differ, f"partitions whose replicas disagree: {differ}"
        lost = lost_writes()
        assert not lost, f"refreshed writes read back below their version: {lost}"
        serving = [list(h.instances[ep].get_serving_status()) for ep in h.live()]
        return {
            "n_nodes": n_nodes, "victim": str(victim),
            "config_ids": [int(c) for c in h.config_ids],
            "config_after_crash": int(config_after_crash), "final_config": int(final_config),
            "placement_version": int(versions.pop()), "fingerprints": fingerprints,
            "acked": {k.decode(): v for k, v in sorted(acked.items())},
            "windows": windows, "sessions": sessions, "serving": serving,
            "replayed_records": replayed, "stale_before_refresh": stale_before_refresh,
            "identity": [[int(i.high), int(i.low)] for i in (old_identity, store.node_id)],
            "virtual_ms": {"bootstrap": int(bootstrap_virtual),
                           "crash_to_agreement": int(crash_to_agreement_virtual),
                           "end": int(h.scheduler.now_ms())},
        }, walls
    finally:
        h.shutdown()


def live_hierarchy_run(P, n_nodes=SERVING_N_NODES, cells=HIER_CELLS, seed=LIVE_SEED):
    """Part (b): ``n_nodes`` members of package ``P`` in ``cells`` cells
    (``HierarchySettings(enabled=True)``), each cell bootstrapped as its own
    Rapid cluster by parallel joins and handed every cell's seed; then the
    leaders of the largest cell crash. Every surviving leader must hold the
    same global fingerprint, equal to a composition recomputed from scratch
    from each cell's live membership, and every member the same composed
    view. Returns the outcome and host walls."""
    settings = P.settings.Settings(hierarchy=P.settings.HierarchySettings(
        enabled=True, cells=cells))
    parent = P.hierarchy_parent
    h = LiveHarness(P, seed, settings)
    walls = {}
    try:
        by_cell = collections.defaultdict(list)
        for i in range(n_nodes):
            by_cell[P.hierarchy_cells.cell_of_endpoint(h.addr(i), cells)].append(i)
        by_cell = dict(sorted(by_cell.items()))
        t0 = time.perf_counter()
        for idxs in by_cell.values():
            h.start(idxs[0])
        h.join_all([(i, idxs[0], {}) for idxs in by_cell.values() for i in idxs[1:]])
        for cluster in h.instances.values():
            cluster.hierarchy.seed_parent([h.addr(idxs[0]) for idxs in by_cell.values()])

        def members_of(c):
            return [h.addr(i) for i in by_cell[c] if h.addr(i) in h.instances]

        def composed():
            rows = []
            for c in by_cell:
                members = members_of(c)
                if not members:
                    continue
                epoch = h.instances[members[0]].get_current_configuration_id()
                rows.append(parent.CellState(
                    cell=c, epoch=epoch, size=len(members),
                    leader=str(parent.cell_leaders(members, 1)[0]),
                    fingerprint=parent.cell_fingerprint(members)))
            want = parent.compose_fingerprint(rows)
            return all(c.hierarchy.global_view.fingerprint() == want
                       for c in h.instances.values()), want

        def settled():
            for c in by_cell:
                members = members_of(c)
                if members and not all(len(h.instances[ep].get_memberlist()) == len(members)
                                       for ep in members):
                    return False
            return composed()[0]

        assert h.scheduler.run_until(settled, timeout_ms=1_200_000, poll_ms=100), (
            "hierarchy: composed views never agreed after the bootstrap")
        walls["bootstrap_ms"] = (time.perf_counter() - t0) * 1e3
        booted = composed()[1]
        big = max(by_cell, key=lambda c: len(by_cell[c]))
        leaders = list(parent.cell_leaders(members_of(big), settings.hierarchy.leaders_per_cell))
        t0 = time.perf_counter()
        crash_virtual = h.scheduler.now_ms()
        h.fail(leaders)
        assert h.scheduler.run_until(settled, timeout_ms=2_400_000, poll_ms=100), (
            "hierarchy: no agreement after the leaders' crash")
        walls["crash_to_agreement_ms"] = (time.perf_counter() - t0) * 1e3
        ok, fingerprint = composed()
        assert ok
        leading = [c for c in h.instances.values() if c.hierarchy.is_leader]
        assert len(leading) == len(by_cell) and len(
            {c.hierarchy.global_view.fingerprint() for c in leading}) == 1
        new_leader = str(parent.cell_leaders(members_of(big), 1)[0])
        assert leading[0].hierarchy.global_view.cells[big].leader == new_leader
        return {
            "n_nodes": n_nodes, "cells": {c: len(v) for c, v in by_cell.items()},
            "crashed": [str(ep) for ep in leaders], "new_leader": new_leader,
            "booted_fingerprint": int(booted), "global_fingerprint": int(fingerprint),
            "member_count": int(leading[0].hierarchy.global_view.member_count()),
            "cell_epochs": {c: int(r.epoch) for c, r in sorted(
                leading[0].hierarchy.global_view.cells.items())},
            "crash_to_agreement_virtual_ms": int(h.scheduler.now_ms() - crash_virtual),
        }, walls
    finally:
        h.shutdown()


def live_recovery_run(P, root, seed=SEED):
    """Part (c): ``bench.run_recovery_dimension``'s points on package ``P``'s
    ``DurablePartitionStore``: 256 and 1024 records of 512 B over 32
    partitions, snapshots never and every 256, crashed and reopened. The
    replayed count must be exact and the recovered content byte-equal to
    what was written. Returns each point (recovery ms apart, a host
    wall)."""
    D = P.durability
    points, walls = [], []
    for every in RECOVERY_SNAPSHOT_EVERY:
        for records in RECOVERY_LOG_RECORDS:
            rng = np.random.default_rng(seed * 7919 + records * 31 + every)
            directory = os.path.join(root, f"recovery-{every}-{records}")
            store = D.DurablePartitionStore(directory, fsync_policy=D.FSYNC_NEVER,
                                            snapshot_every_records=every)
            shadow = {}
            for i in range(records):
                p = int(rng.integers(RECOVERY_PARTITIONS))
                value = b"%08d-" % i + bytes(
                    rng.integers(0, 256, RECOVERY_VALUE_BYTES, dtype=np.uint8))
                store.put(p, value)
                shadow[p] = value
            store.crash()
            t0 = time.perf_counter()
            reopened = D.DurablePartitionStore(directory, fsync_policy=D.FSYNC_NEVER,
                                               snapshot_every_records=every)
            walls.append((time.perf_counter() - t0) * 1e3)
            stats = reopened.durability_stats()
            expected = records % every if every else records
            assert stats["replayed_records"] == expected, (records, every, stats)
            assert {p: reopened.get(p) for p in reopened.partitions()} == shadow, (
                "recovery: recovered content differs from what was written")
            points.append({"log_records": records, "snapshot_every": every,
                           "replayed_records": int(stats["replayed_records"]),
                           "segments": int(stats["segments"]),
                           "digest": [list(x) for x in reopened.digest()]})
            reopened.close()
    return points, walls


def live_planes_sequence(P, root, n_nodes=SERVING_N_NODES, cells=HIER_CELLS, ops=SERVING_OPS):
    """The three live-plane runs on package ``P`` under directory ``root``:
    serving over durable stores through a crash and a WAL restart, the
    hierarchy through a leaders' crash, and the recovery points. Returns
    ``(outcome, walls)``: the outcome is what ``tests/golden/
    torch_live_planes.json`` holds (the JAX package's), the walls are this
    host's."""
    serving, serving_walls = live_serving_run(P, os.path.join(root, "serving"), n_nodes, ops)
    hierarchy, hierarchy_walls = live_hierarchy_run(P, n_nodes, cells)
    recovery, recovery_walls = live_recovery_run(P, os.path.join(root, "recovery"))
    return ({"serving": serving, "hierarchy": hierarchy, "recovery": recovery},
            {"serving": serving_walls, "hierarchy": hierarchy_walls,
             "recovery_ms": recovery_walls})


def live_golden_check(outcome, section):
    """``outcome`` against ``section`` of ``tests/golden/torch_live_planes.json``
    (``"full"`` or ``"reduced"``), exactly; returns the misses."""
    with open(LIVE_GOLDEN) as f:
        want = json.load(f)[section]
    return _golden_misses(json.loads(json.dumps(outcome)), want)


def live_planes_phase(card):
    """The live planes on the port at the bench's serving size, held to the
    golden file; prints the walls. Launches no kernel."""
    import tempfile

    from rapid_tpu_torch.sim import kernels

    P = live_modules("rapid_tpu_torch")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-live-") as root:
        outcome, walls = live_planes_sequence(P, root)
    phase_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    misses = live_golden_check(outcome, "full")
    assert not misses, "live planes differ from tests/golden/torch_live_planes.json: " + "; ".join(
        misses[:8])
    s, sw = outcome["serving"], walls["serving"]
    print(f"live planes, serving: {s['n_nodes']} port members, placement "
          f"{LIVE_PLACEMENT['partitions']} x {LIVE_PLACEMENT['replicas']}, each on its own "
          f"DurablePartitionStore; bootstrap (sequential joins, handoff drained) "
          f"{sw['bootstrap_ms']:.1f} ms host, {s['virtual_ms']['bootstrap']} ms virtual; "
          f"crash of {s['victim']} (leads the hottest key's partition) to agreement "
          f"{sw['crash_to_agreement_ms']:.1f} ms host (churn window included), "
          f"{s['virtual_ms']['crash_to_agreement']} ms virtual; WAL restart and rejoin "
          f"{sw['restart_ms']:.1f} ms host, replayed {s['replayed_records']} records ({card})",
          flush=True)
    for name, w in s["windows"].items():
        print(f"live planes, serving window {name}: {w['ops']} ops, {w['ok']} ok, p50 "
              f"{w['p50_ms']} ms p99 {w['p99_ms']} ms virtual over {w['virtual_ms']} ms "
              f"virtual", flush=True)
    print(f"live planes, serving checks: {len(s['acked'])} acked keys read back at or above "
          f"their versions from survivors; handoff sessions {s['sessions']} all complete; "
          f"{len(s['fingerprints'])} partitions' replicas equal; one configuration id and "
          f"placement version {s['placement_version']} on every member", flush=True)
    hr, hw = outcome["hierarchy"], walls["hierarchy"]
    print(f"live planes, hierarchy: {hr['n_nodes']} members in {len(hr['cells'])} cells "
          f"{hr['cells']}; bootstrap {hw['bootstrap_ms']:.1f} ms host; crash of "
          f"{hr['crashed']} to agreement {hw['crash_to_agreement_ms']:.1f} ms host, "
          f"{hr['crash_to_agreement_virtual_ms']} ms virtual; every leader's global "
          f"fingerprint {hr['global_fingerprint']} == the recompute ({card})", flush=True)
    for point, ms in zip(outcome["recovery"], walls["recovery_ms"]):
        print(f"live planes, recovery: {point['log_records']} records, snapshot every "
              f"{point['snapshot_every']}: replayed {point['replayed_records']} (exact), "
              f"content equal, {ms:.3f} ms ({card})", flush=True)
    print(f"live planes, golden: every id, fingerprint, acked version, session and serving "
          f"count, global fingerprint and replayed count equals "
          f"tests/golden/torch_live_planes.json; kernels launched {launches or 'none'}; "
          f"phase {phase_s:.1f} s", flush=True)
    assert not launches, f"the live planes launched kernels: {launches}"
    return {"outcome_summary": {"config_ids": s["config_ids"],
                                "global_fingerprint": hr["global_fingerprint"]},
            "walls": walls, "phase_s": phase_s, "launches": launches}


# --- the nemesis search and the forensics timeline: host code on seeded
# random.Random, except the sim harness, whose Simulator runs on the card ---
SEARCH_MODULES = ("faults", "forensics.bundle", "forensics.hlc", "forensics.timeline",
                  "observability", "search.coverage", "search.hunt", "search.runner",
                  "sim.driver")
SEARCH_ENGINE_HUNT = {"seed": 0, "budget": 200}  # tools/hunt.py's defaults
SEARCH_BUG_HUNT = {"seed": 12, "budget": 120, "shrink_budget": 150}  # the README's demo
SEARCH_SIM_HUNT = {"seed": 0, "budget": 20}  # the README's --harness sim --budget 20
SEARCH_WIDE_N = N_NODES  # (d): the bench headline's members, at SIM_DEFAULTS' workload
SEARCH_WIDE_SEED = SEED
SEARCH_CORPUS_PIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios",
                                 "corpus", "hunt-s11-engine-linearizability-0.json")
SEARCH_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "golden", "torch_search.json")
# the tier-1 twin of the phase (tests/test_torch_search_golden.py): fewer probes,
# and (d) at the search's own capacity
SEARCH_REDUCED = {"engine_budget": 30, "sim_budget": 10, "wide_n": 5}
BUG_FLAG = "RAPID_BUG_NEWROW_SYNC"


def search_modules():
    """``live_modules`` of the port plus the search's and the timeline's
    modules and the forensics CLI's ``main`` (``rapid_tpu_torch.cli.forensics``).
    The JAX package's namespace, which the golden generator and the twins
    build, lives with them (``tests/test_torch_timeline.py``)."""
    import importlib

    ns = live_modules("rapid_tpu_torch")
    for module in SEARCH_MODULES:
        setattr(ns, module.replace(".", "_"), importlib.import_module(f"rapid_tpu_torch.{module}"))
    ns.forensics_main = importlib.import_module("rapid_tpu_torch.cli.forensics").main
    return ns


@contextlib.contextmanager
def _bug_flag(on):
    """``RAPID_BUG_NEWROW_SYNC`` set to ``on`` inside the block, restored after."""
    saved = os.environ.pop(BUG_FLAG, None)
    if on:
        os.environ[BUG_FLAG] = "1"
    try:
        yield
    finally:
        os.environ.pop(BUG_FLAG, None)
        if saved is not None:
            os.environ[BUG_FLAG] = saved


def _signals(coverage):
    return sorted(list(s) for s in coverage)


def _kinds(result):
    return sorted({v["invariant"] for v in result.violations})


def draws_loss(spec):
    """Whether the plan of ``spec`` has a device rule that drops below
    probability 1.0, so that the probe's simulator draws random loss (from
    its state's key, threefry's bits in both packages)."""
    return spec.get("harness") == "sim" and any(
        r.get("type") in ("DropRule", "LossyLinkRule") and r.get("probability", 1.0) < 1.0
        and r.get("msg_types") != ["Put"]
        for r in spec["plan"].get("rules", []))


class _ProbeLog:
    """Every ``run_probe`` the hunter of package ``P`` makes, with the
    configuration id the sim harness folds last (its parity check's)."""

    def __init__(self, P):
        self.hunt, self.sim_class = P.search_hunt, P.sim_driver.Simulator
        self.probes = []

    def __enter__(self):
        self.run_probe, self.configuration_id = self.hunt.run_probe, self.sim_class.configuration_id
        ids = []

        def configuration_id(sim):
            ids.append(self.configuration_id(sim))
            return ids[-1]

        def run_probe(spec, **kw):
            del ids[:]
            result = self.run_probe(spec, **kw)
            self.probes.append({"spec": spec, "kinds": _kinds(result), "info": result.info,
                                "coverage_signals": len(result.coverage),
                                "configuration_id": ids[-1] if ids else None,
                                "draws_loss": draws_loss(spec)})
            return result

        self.hunt.run_probe, self.sim_class.configuration_id = run_probe, configuration_id
        return self

    def __exit__(self, *exc):
        self.hunt.run_probe, self.sim_class.configuration_id = self.run_probe, self.configuration_id


def wide_probe_spec(P, n):
    """(d): ``SIM_DEFAULTS``' workload at capacity and members ``n``, the gray
    streak on (``fd_gray_confirm`` 3), slot 2 restarted over [5000, 9000] ms and
    an ingress drop at probability 1.0 on slot 7 (slot 3 below 8 members) from
    2000 ms on: no draw below 1.0, so exact on both packages."""
    defaults = dict(P.search_hunt.SIM_DEFAULTS, n=n, capacity=n)
    ends = P.search_hunt.harness_endpoints("sim", defaults)
    return {"harness": "sim", **defaults, "fd_gray_confirm": 3, "plan": {
        "seed": SEARCH_WIDE_SEED, "rules": [
            {"type": "RestartNodeRule", "at": "egress", "windows": [[5000, 9000]],
             "src": None, "dst": ends[2], "msg_types": None},
            {"type": "DropRule", "at": "ingress", "windows": [[2000, None]], "src": None,
             "dst": ends[7 if n > 7 else 3], "msg_types": None, "probability": 1.0}]}}


def _cli(P, *argv):
    """The forensics CLI's exit code on ``argv`` (its output swallowed)."""
    import io

    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return P.forensics_main(list(argv))


def _journal_bundle(P, events):
    """``tests/test_forensics.py``'s ``_bundle_with``: one member's journal of
    ``events`` stamped by an HLC whose physical clock reads 1000."""
    rec = P.observability.FlightRecorder(capacity=64, node="10.0.0.1:9001",
                                         hlc=P.forensics_hlc.HlcClock(clock=lambda: 1000))
    for kind, detail in events:
        rec.record(kind, virtual_ms=100, **detail)
    local = P.forensics_bundle.capture_local_evidence(node="10.0.0.1:9001", recorder=rec)
    return P.forensics_bundle.build_bundle("explicit", local)


def skewed_churn_bundle(P, seed=31):
    """``tests/test_forensics.py``'s skewed churn on package ``P``: three
    members with the forensics plane on, the second clock 500 ms ahead and the
    third 500 ms behind, the first crashed; the survivors' classic fallback
    agrees on two, and the second captures the cluster's bundle."""
    S = P.settings
    h = LiveHarness(P, seed, S.Settings(forensics=S.ForensicsSettings(enabled=True)))
    h.with_faults(P.faults.FaultPlan(seed=3).clock_skew(h.addr(1), offset_ms=500)
                  .clock_skew(h.addr(2), offset_ms=-500))
    try:
        h.start(0)
        for i in (1, 2):
            h.join_all([(i, 0, {})])
        h.agree(h.live())
        h.fail([h.addr(0)])
        h.agree(h.live(), timeout_ms=1_500_000)
        promise = h.instances[h.addr(1)].capture_bundle_async(trigger="explicit")
        assert h.scheduler.run_until(promise.done, timeout_ms=120_000)
        assert promise.exception() is None, promise.exception()
        bundle = promise.peek()
    finally:
        h.shutdown()
    assert bundle["manifest"]["members"] == 2 and bundle["manifest"]["unreachable"] == []
    return bundle


def _normalized(P, bundle):
    """What the timeline reads of ``bundle``, without what the host put in it:
    journal wall times zeroed, span and trace ids (each process numbers its
    own) renumbered in order of first appearance, and the fingerprint taken
    over what is left."""
    ids = {"trace_id": {}, "span_id": {}}

    def renumber(fields):
        out = dict(fields)
        for key, seen in ids.items():
            value = out.get(key)
            if value:
                out[key] = seen.setdefault(value, type(value)(len(seen) + 1))
        return out

    members = []
    for m in bundle["members"]:
        journal = []
        for entry in m.get("journal", []):
            entry = dict(renumber(entry), wall_s=0.0)
            if isinstance(entry.get("detail"), dict):
                entry["detail"] = renumber(entry["detail"])
            journal.append(entry)
        members.append({"node": m["node"], "journal": journal,
                        "journal_dropped": m.get("journal_dropped", 0)})
    manifest = dict(bundle["manifest"],
                    fingerprint=P.forensics_bundle.bundle_fingerprint(members))
    return {"trigger": bundle["trigger"], "captured_by": bundle["captured_by"],
            "manifest": manifest, "members": members}


def _sha(doc):
    import hashlib

    return hashlib.sha256(json.dumps(doc, sort_keys=True, default=str).encode()).hexdigest()


def timeline_digest(P, bundles, paths):
    """Package ``P``'s timeline over ``bundles`` (normalized): the merged
    events, the findings, the Chrome trace and the report text (digests of
    the three long ones), and the forensics CLI's exit codes on the bundle
    files ``paths`` as written."""
    T = P.forensics_timeline
    normal = [_normalized(P, b) for b in bundles]
    events = T.merge_timeline(normal)
    findings = T.detect_signatures(events)
    report = T.report_text(events, findings, normal)
    return {"events": len(events), "nodes": sorted({e.node for e in events}),
            "stamped": all(e.hlc is not None for e in events),
            "kinds": dict(collections.Counter(e.kind for e in events)),
            "events_sha256": _sha([e.to_journal_entry() for e in events]),
            "chrome_trace_sha256": _sha(T.timeline_chrome_trace(events)),
            "report_sha256": _sha(report), "report_lines": report.count("\n") + 1,
            "findings": json.loads(json.dumps(findings, default=str)),
            "report_rc": _cli(P, "report", *paths),
            "verify_rc": [_cli(P, "verify", p) for p in paths]}


def sim_hunt(P, device=None, budget=None):
    """(c) of ``search_sequence``: the simulator hunt of package ``P`` at
    ``SEARCH_SIM_HUNT`` (``budget`` probes if given), its report, coverage
    and every probe (``_ProbeLog``)."""
    c = SEARCH_SIM_HUNT if budget is None else dict(SEARCH_SIM_HUNT, budget=budget)
    dev = {} if device is None else {"device": device}
    with _bug_flag(False), _ProbeLog(P) as log:
        report = P.search_hunt.Hunter(harness="sim", **c, **dev).run()
    return {"report": report.to_json(), "coverage": _signals(report.coverage),
            "probes": log.probes}


def search_sequence(P, root, device=None, counter=None, engine_budget=None, sim_budget=None,
                    wide_n=SEARCH_WIDE_N):
    """The search phase's runs (a)-(e) on package ``P`` (``search_modules``)
    under directory ``root``; ``device`` goes to every ``sim`` probe (the
    port's; None for the JAX package). ``counter``: (reset, read) of the
    kernel launch counts, reset before each run and read after it. Returns
    ``(outcome, walls)``: the outcome is what ``tests/golden/torch_search.json``
    holds (the JAX package's), the walls this host's seconds and the launches."""
    H, R = P.search_hunt, P.search_runner
    dev = {} if device is None else {"device": device}
    reset, read = counter or ((lambda: None), dict)
    out, walls = {}, {}

    def timed(name, fn):
        reset()
        t0 = time.perf_counter()
        value = fn()
        walls[name] = {"s": time.perf_counter() - t0,
                       "launches": {k: v for k, v in read().items() if v}}
        return value

    # (a) the engine hunt at the CLI's defaults
    a = SEARCH_ENGINE_HUNT if engine_budget is None else dict(SEARCH_ENGINE_HUNT,
                                                             budget=engine_budget)
    with _bug_flag(False):
        report = timed("engine_hunt", lambda: H.Hunter(harness="engine", **a, **dev).run())
    out["engine_hunt"] = {"report": report.to_json(), "coverage": _signals(report.coverage),
                          "transitions": report.transition_count()}

    # (b) the flagged bug: found, shrunk to at most 3 rules, pinned; the
    # corpus pin green without the flag and violating with it
    b = SEARCH_BUG_HUNT
    with _bug_flag(True):
        report = timed("bug_hunt", lambda: H.Hunter(harness="engine", **b, **dev).run())
    assert report.pinned, "the flagged bug was not found"
    pin = report.pinned[0]
    assert len(pin["spec"]["plan"]["rules"]) <= 3, pin
    name = f"hunt-s{b['seed']}-engine-{'-'.join(pin['kinds'])}-0"
    path = os.path.join(root, f"{name}.json")
    H.pin_to_file(pin, path, name, f"shrunk by tools/hunt.py --seed {b['seed']} "
                                   f"--budget {b['budget']} --harness engine")
    with open(path) as f:
        pin_bytes = f.read()
    with open(SEARCH_CORPUS_PIN) as f:
        corpus = {k: v for k, v in json.load(f).items()
                  if k not in ("name", "description", "expect")}
    replays = {}
    for label, on in (("flag_off", False), ("flag_on", True)):
        with _bug_flag(on):
            result = R.run_probe(corpus, **dev)
        replays[label] = {"kinds": _kinds(result), "info": result.info,
                          "coverage_signals": len(result.coverage)}
    assert replays["flag_off"]["kinds"] == [] and replays["flag_on"]["kinds"], replays
    out["bug_hunt"] = {"report": report.to_json(), "pin": pin, "pin_bytes": pin_bytes,
                       "corpus_replay": replays}

    # (c) the simulator hunt at the search's own size (SIM_DEFAULTS, capacity 5)
    out["sim_hunt"] = timed("sim_hunt", lambda: sim_hunt(P, device, sim_budget))

    # (d) one simulator probe at full width
    spec = wide_probe_spec(P, wide_n)
    with _bug_flag(False):
        result = timed("wide_probe", lambda: R.run_probe(spec, **dev))
    out["wide_probe"] = {"spec": spec, "kinds": _kinds(result),
                         "violations": list(result.violations), "info": result.info,
                         "coverage": _signals(result.coverage)}

    # (e) the timeline: (b)'s witness sidecar, taken with the forensics mirror
    # on, the skewed churn's cluster bundle, and the stuck-handoff fixtures
    def timeline():
        with _bug_flag(True):
            witness = H.Hunter(harness="engine", forensics=True, **b, **dev).run()
        pin = witness.pinned[0]
        assert "bundle" in pin, "the forensics hunt pinned no evidence bundle"
        sidecar = os.path.join(root, "witness.json")
        H.pin_to_file(pin, sidecar, "witness", "the flagged bug's witness")
        cases = {"witness": [P.forensics_bundle.load_bundle(sidecar + ".bundle.json")],
                 "skewed_churn": [skewed_churn_bundle(P)],
                 "stuck_handoff": [_journal_bundle(P, [
                     ("handoff_started", {"sessions": 2, "version": 4}),
                     ("handoff_complete", {"partition": 0})])],
                 "clean": [_journal_bundle(P, [
                     ("handoff_started", {"sessions": 1, "version": 4}),
                     ("handoff_complete", {"partition": 0})])]}
        digests = {}
        for label, bundles in cases.items():
            paths = []
            for i, bundle in enumerate(bundles):
                paths.append(os.path.join(root, f"{label}-{i}.json"))
                P.forensics_bundle.write_bundle(bundle, paths[-1])
            digests[label] = timeline_digest(P, bundles, paths)
        tampered = P.forensics_bundle.load_bundle(os.path.join(root, "clean-0.json"))
        tampered["members"][0]["metrics"] = {"messages.forged": 1}
        with open(os.path.join(root, "tampered.json"), "w") as f:
            json.dump(tampered, f)
        digests["tampered_verify_rc"] = _cli(P, "verify", os.path.join(root, "tampered.json"))
        return digests

    out["timeline"] = timed("timeline", timeline)
    return json.loads(json.dumps(out)), walls


def search_golden_misses(outcome, want):
    """``outcome`` against a section ``want`` of ``tests/golden/torch_search.json``,
    exactly: (c)'s probes whose plans draw loss below 1.0 (``draws_loss``)
    included, since the port draws threefry's bits as the JAX package does.
    Returns the misses."""
    return [m for key in ("engine_hunt", "bug_hunt", "sim_hunt", "wide_probe", "timeline")
            for m in _golden_misses(outcome[key], want[key], f"/{key}")]


def search_phase(card):
    """The nemesis search and the forensics timeline on the port, the sim
    harness's simulators on the card, held to the golden file's ``full``
    section; prints each run's wall, probes, violations and launches."""
    import tempfile

    from rapid_tpu_torch.sim import kernels

    P = search_modules()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-search-") as root:
        outcome, walls = search_sequence(
            P, root, device="cuda",
            counter=(kernels.reset_launches, lambda: dict(kernels.LAUNCHES)))
    phase_s = time.perf_counter() - t0
    with open(SEARCH_GOLDEN) as f:
        want = json.load(f)["full"]
    misses = search_golden_misses(outcome, want)
    for name in ("engine_hunt", "bug_hunt", "sim_hunt"):
        r, w = outcome[name]["report"], walls[name]
        print(f"search, {name}: seed {r['seed']}, harness {r['harness']}, {r['probes']} probes, "
              f"{len(r['violations'])} violating, {len(r['pinned'])} pinned, "
              f"{r['coverage_signals']} coverage signals, {r['event_transitions']} transitions; "
              f"{w['s'] * 1e3:.1f} ms host; launches {w['launches'] or 'none'} ({card})",
              flush=True)
    b = outcome["bug_hunt"]
    print(f"search, bug_hunt pin: {b['pin']['kinds']} with "
          f"{len(b['pin']['spec']['plan']['rules'])} rule(s) after "
          f"{b['pin']['shrink_probes']} shrink probes, {len(b['pin_bytes'])} bytes pinned; corpus "
          f"{os.path.basename(SEARCH_CORPUS_PIN)}: flag off {b['corpus_replay']['flag_off']['kinds']}, "
          f"flag on {b['corpus_replay']['flag_on']['kinds']}", flush=True)
    probes = outcome["sim_hunt"]["probes"]
    lossy = [i for i, p in enumerate(probes) if p["draws_loss"]]
    print(f"search, sim_hunt probes: {len(probes)} on cuda, capacity "
          f"{probes[0]['spec']['capacity']}; {len(lossy)} drawing loss below 1.0 {lossy}, held "
          f"exactly like the rest; violations {sum(1 for p in probes if p['kinds'])}",
          flush=True)
    d, dw = outcome["wide_probe"], walls["wide_probe"]
    print(f"search, wide_probe: {d['spec']['n']} members, fd_gray_confirm "
          f"{d['spec']['fd_gray_confirm']}, restart {d['spec']['plan']['rules'][0]['dst']} and "
          f"ingress drop 1.0 on {d['spec']['plan']['rules'][1]['dst']}: violations "
          f"{d['kinds'] or 'none'}, view changes {d['info']['view_changes']}, virtual "
          f"{d['info']['virtual_ms']} ms, acked puts {d['info']['acked_puts']}, history "
          f"{d['info']['history']}, replayed {d['info']['replayed_records']}, "
          f"{len(d['coverage'])} coverage signals; {dw['s'] * 1e3:.1f} ms host; launches "
          f"{dw['launches']} ({card})", flush=True)
    for label, t in outcome["timeline"].items():
        if isinstance(t, dict):
            print(f"search, timeline {label}: {t['events']} events on {len(t['nodes'])} nodes, "
                  f"findings {[f['signature'] for f in t['findings']] or 'none'}, report rc "
                  f"{t['report_rc']}, verify rc {t['verify_rc']}", flush=True)
    print(f"search, timeline: tampered bundle verify rc "
          f"{outcome['timeline']['tampered_verify_rc']}; {walls['timeline']['s'] * 1e3:.1f} ms host",
          flush=True)
    assert not misses, f"search differs from {SEARCH_GOLDEN}: " + "; ".join(misses[:8])
    launches = walls["wide_probe"]["launches"]
    assert launches.get("fd_phase_fused", 0) >= 1, launches
    assert launches.get("placement_topr", 0) >= 1, launches
    for run in walls.values():
        assert run["launches"].get("fd_phase_u8", 0) == 0, run
    print(f"search, golden: (a)-(e) equal tests/golden/torch_search.json's full section; "
          f"phase {phase_s:.1f} s", flush=True)
    return {"walls": walls, "phase_s": phase_s, "lossy_probes": lossy,
            "wide_info": d["info"]}


NATIVE_ENTRY_POINTS = ("xxh64_batch", "ring_hashes", "build_adjacency", "config_fold")
NATIVE_K = 10
NATIVE_BIG = 1_000_000  # (b)'s native-only size, checked on a sample
NATIVE_SAMPLE = 10_000
NATIVE_REPS = 3
SCRAPE_MEMBERS = 3


@contextlib.contextmanager
def numpy_paths():
    """Every entry point of the port's native host library answers None, as
    where the library is unavailable, so each caller takes its numpy path;
    restored on exit. This script's own switch: the package has none."""
    from rapid_tpu_torch import native

    saved = {name: getattr(native, name) for name in NATIVE_ENTRY_POINTS}
    for name in saved:
        setattr(native, name, lambda *a, **k: None)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def start_native_builds():
    """Start, beside the kernel build, the g++ builds of (a) and (f), each
    in a thread of its own: both host libraries and the stress harness under
    every sanitizer the toolchain links. Returns the threads; ``native_build``
    joins them. A build that fails here is tried again, and reported, by
    the phase that needs it; (a) and (f) print each build's wall from
    ``native.BUILD_WALLS``."""
    from rapid_tpu_torch import native
    from rapid_tpu_torch.runtime import native_io

    def quietly(build, *args):
        try:
            build(*args)
        except RuntimeError:
            pass

    def stress(sanitizer):
        if not native.sanitizer_missing(sanitizer):
            quietly(native.build_stress, sanitizer)

    jobs = [(quietly, native.build_library, native.SOURCE),
            (quietly, native.build_library, native_io.SOURCE, native_io.CXX_FLAGS)]
    jobs += [(stress, sanitizer) for sanitizer in native.SANITIZERS]
    threads = [threading.Thread(target=job[0], args=job[1:], daemon=True) for job in jobs]
    for thread in threads:
        thread.start()
    return threads


def native_build(card, builds=()):
    """(a) Both host libraries built from ``rapid_tpu_torch/csrc/host/`` with
    g++ and loaded; no fallback: the run fails when either does not.
    ``builds``: ``start_native_builds``' threads, joined first."""
    from rapid_tpu_torch import native
    from rapid_tpu_torch.runtime import native_io

    for thread in builds:
        thread.join()
    t0 = time.perf_counter()
    lib = native.load()
    t1 = time.perf_counter()
    io = native_io.load()
    t2 = time.perf_counter()
    assert lib is not None and io is not None, f"native: a host library is unavailable: " \
        f"{native.ERRORS}"
    walls = {stem: native.BUILD_WALLS.get(stem) for stem in ("rapid_native", "rapid_io")}
    print(f"native, build: g++ rapid_native.cpp "
          + ("reused" if walls["rapid_native"] is None else f"{walls['rapid_native']:.2f} s")
          + ", rapid_io.cpp "
          + ("reused" if walls["rapid_io"] is None else f"{walls['rapid_io']:.2f} s")
          + f" (build and load {t1 - t0:.2f} s and {t2 - t1:.2f} s) into "
          f"{native.BUILD_DIR} ({card})", flush=True)
    return {"gxx_s": walls, "load_s": {"rapid_native": t1 - t0, "rapid_io": t2 - t1}}


def native_stress(card):
    """(f) The reactor's sanitizer stress harness
    (``csrc/host/rapid_io_stress.cpp`` with ``rapid_io.cpp``) built and run
    under ThreadSanitizer and AddressSanitizer: one line each with the build
    and run seconds and the harness's ``stress ok`` line, with the compiler
    that built it (``native.stress_compiler``). A toolchain that cannot link
    a sanitizer at all is reported and the run goes on; a build failure or a
    sanitizer report fails it."""
    from rapid_tpu_torch import native

    rows = {}
    for sanitizer in native.SANITIZERS:
        missing = native.sanitizer_missing(sanitizer)
        if missing:
            rows[sanitizer] = {"absent": missing}
            print(f"native, stress -fsanitize={sanitizer}: absent, the toolchain cannot link "
                  f"it ({missing}) ({card})", flush=True)
            continue
        compiler = native.stress_path(sanitizer)[1][0]
        t0 = time.perf_counter()
        native.build_stress(sanitizer)
        t1 = time.perf_counter()
        line, no_aslr = native.run_stress(sanitizer)
        t2 = time.perf_counter()
        # a build started beside the kernel build has its wall recorded there
        build_s = native.BUILD_WALLS.get(f"rapid_io_stress-{sanitizer}", t1 - t0)
        rows[sanitizer] = {"compiler": compiler, "build_s": build_s, "run_s": t2 - t1,
                           "line": line, "aslr_off": no_aslr}
        print(f"native, stress -fsanitize={sanitizer}: {compiler} build {build_s:.2f} s, run "
              f"{t2 - t1:.2f} s, {line}"
              + (" (run again under setarch -R: TSAN refused the address layout)"
                 if no_aslr else "") + f" ({card})", flush=True)
    return rows


def _timed_ms(fn, reps):
    """``fn()``'s result and its walls in ms over ``reps`` calls."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, walls


def native_hashes(card, n=N_NODES, big=NATIVE_BIG, sample=NATIVE_SAMPLE, k=NATIVE_K,
                  seed=SEED, reps=NATIVE_REPS):
    """(b) The native entry points against the port's numpy paths on the
    bench headline's synthesized cluster (``VirtualCluster.synthesize(n, k,
    seed)``): ``synthesize`` itself, ``ring_hashes``, ``xxh64_batch`` on the
    hostnames and ``config_fold`` over the elements' hashes, each equal, each
    wall both ways (median of ``reps``). At ``big`` the native path alone is
    timed and held to the numpy path on a seeded sample of ``sample`` rows
    (the fold in full)."""
    from rapid_tpu_torch import hashing, native
    from rapid_tpu_torch.sim import topology

    def cases(vc, rows=None):
        data, lengths, ports = vc.hostnames, vc.host_lengths, vc.ports
        hashes = vc.node_hashes()
        if rows is not None:
            data, lengths, ports = data[rows], lengths[rows], ports[rows]
        return {
            "ring_hashes": (lambda: native.ring_hashes(vc.hostnames, vc.host_lengths,
                                                       vc.ports, k),
                            lambda: np.stack([hashing.endpoint_hash_batch(data, lengths, ports,
                                                                          r)
                                              for r in range(k)])),
            "xxh64_batch": (lambda: native.xxh64_batch(vc.hostnames, vc.host_lengths, 0),
                            lambda: hashing.xxh64_batch(data, lengths, 0)),
            "config_fold": (lambda: topology.config_fold(*hashes),
                            lambda: _numpy_call(topology.config_fold, *hashes)),
        }

    out = {}
    got, nat = _timed_ms(lambda: topology.VirtualCluster.synthesize(n, k, seed), reps)
    want, plain = _timed_ms(lambda: _numpy_call(topology.VirtualCluster.synthesize, n, k, seed),
                            reps)
    assert np.array_equal(got.ring_hashes, want.ring_hashes), "native: synthesize differs"
    out[f"synthesize {n}"] = {"native_ms": nat, "numpy_ms": plain}
    for name, (fn, ref) in cases(got).items():
        a, nat = _timed_ms(fn, reps)
        b, plain = _timed_ms(ref, reps)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"native: {name} differs at {n}"
        out[f"{name} {n}"] = {"native_ms": nat, "numpy_ms": plain}
    del got, want
    vc, nat = _timed_ms(lambda: topology.VirtualCluster.synthesize(big, k, seed), 1)
    out[f"synthesize {big}"] = {"native_ms": nat, "numpy_ms": None}
    rows = np.sort(np.random.default_rng(seed).choice(big, sample, replace=False))
    for name, (fn, ref) in cases(vc, rows).items():
        a, nat = _timed_ms(fn, reps)
        b = ref()
        if name != "config_fold":
            a = np.asarray(a)[..., rows]
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"native: {name} differs at {big}"
        out[f"{name} {big}"] = {"native_ms": nat, "numpy_ms": None,
                                "checked_rows": None if name == "config_fold" else sample}
    for label, r in out.items():
        print(f"native, {label}: equal to the numpy path"
              + ("" if r.get("checked_rows") is None else
                 f" on a seeded sample of {r['checked_rows']} rows")
              + f"; native {statistics.median(r['native_ms']):.3f} ms"
              + ("" if r["numpy_ms"] is None else
                 f", numpy {statistics.median(r['numpy_ms']):.3f} ms")
              + f" (median of {len(r['native_ms'])}; {card})", flush=True)
    assert native.CALLS["ring_hashes"] > 0 and native.CALLS["config_fold"] > 0, native.CALLS
    return out


def _numpy_call(fn, *args):
    with numpy_paths():
        return fn(*args)


NATIVE_JOIN_TURNS = ("numpy",)  # (c): the member's join again, on the numpy path
NATIVE_VIEW_TURNS = ("native", "numpy")


def native_view_builds(n, card, turns=NATIVE_VIEW_TURNS, k=NATIVE_K, seed=SEED):
    """(c) The view build alone, where the join's host time goes: a
    ``MembershipView`` of the bench headline's ``n`` synthesized endpoints
    and node ids (``_bulk_insert`` and the identifier insort) and its
    configuration id, on the native path or under ``numpy_paths``, in
    ``turns``, each after a ``gc.collect()``; split by phase as
    ``_MemberClock`` splits a join. Every view has one configuration id;
    the medians of each path printed."""
    from rapid_tpu_torch import native
    from rapid_tpu_torch.membership import MembershipView
    from rapid_tpu_torch.sim.topology import VirtualCluster
    from rapid_tpu_torch.types import Endpoint, NodeId

    vc = VirtualCluster.synthesize(n, k, seed)
    endpoints = [Endpoint(bytes(vc.hostnames[i, :vc.host_lengths[i]]), int(vc.ports[i]))
                 for i in range(n)]
    node_ids = [NodeId(int(h), int(lo)) for h, lo in zip(vc.id_high, vc.id_low)]
    clock, rows, ids = _MemberClock(), [], set()
    for path in turns:
        gc.collect()
        calls = native.CALLS["ring_hashes"]
        clock.reset()
        t0 = time.perf_counter()
        with clock, numpy_paths() if path == "numpy" else contextlib.nullcontext():
            view = MembershipView(k, node_ids, endpoints)
            ids.add(view.get_current_configuration_id())
        rows.append(dict(clock.split, wall=(time.perf_counter() - t0) * 1e3, path=path))
        assert (native.CALLS["ring_hashes"] > calls) == (path == "native"), path
        del view
    assert len(ids) == 1, ids
    medians = {}
    for path in sorted(set(turns)):
        mine = [r for r in rows if r["path"] == path]
        medians[path] = {key: statistics.median(r[key] for r in mine)
                         for key in ("bulk_insert", "identifier_insort", "configuration_id",
                                     "wall")}
        print(f"native, view build of {n} endpoints on the {path} path, median of {len(mine)} "
              f"in turns {list(turns)}: "
              + ", ".join(f"{key} {v:.3f} ms" for key, v in medians[path].items())
              + f"; each wall {[round(r['wall'], 1) for r in mine]} ms; configuration id "
              f"{next(iter(ids))} ({card})", flush=True)
    return {"turns": rows, "medians": medians, "configuration_id": next(iter(ids))}


def native_member_join(n, device, card, native_join, turns=NATIVE_JOIN_TURNS):
    """(c) The member phase's one-member join ran on the native path
    (``native_join``, ``member_sequence``'s first row: its
    ``native.CALLS["ring_hashes"]`` must have grown). Then the same join
    alone (``join_only``) in ``turns``: on the native path, or under
    ``numpy_paths``. Every join reaches one configuration id; each build
    printed by phase. ``native_view_builds`` then times the view build
    alone, in turns."""
    assert native_join["native_calls"].get("ring_hashes", 0) >= 1, native_join["native_calls"]
    rows = []
    for path in turns:
        with numpy_paths() if path == "numpy" else contextlib.nullcontext():
            row = member_sequence(n, device, join_only=True)["pumps"][0]
        assert (row["native_calls"].get("ring_hashes", 0) >= 1) == (path == "native"), \
            (path, row["native_calls"])
        assert row["configuration_id"] == native_join["configuration_id"] \
            == row["plain_configuration_id"], (path, row, native_join)
        rows.append(dict(row, path=path))
    for label, r in [("the member phase's join (native)", native_join)] + [
            (f"member join {i + 1} of {len(rows)} ({r['path']})", r)
            for i, r in enumerate(rows)]:
        print(f"native, {label}: {r['members_before']} members, configuration id "
              f"{r['configuration_id']}; wall {r['wall_ms']:.3f} ms, the member's view and "
              f"service build {r['member_build_ms']:.3f} ms = "
              f"{_split_text(r['member_build_split'])}; native calls {r['native_calls']} "
              f"({card})", flush=True)
    return {"member_phase": native_join, "joins": rows, "views": native_view_builds(n, card)}


def native_gateway(n, device, agent):
    """(d) The gateway's front door on the C++ epoll reactor: ``agent_sequence``
    with the agent on ``--transport native-tcp`` against a native-server
    gateway, every id equal to the plain simulator's and the agent's status
    RPC (the agent draws its node id, so its ids are not the earlier agent
    run's), the scan crash's pump launching ``fd_phase_fused`` on the card.
    Walls printed beside the tcp agent's (``agent``). The scripted member's
    run behind the reactor (``gateway_sequence(native_server=True)``) is
    left to ``tests/test_torch_native_tcp.py`` on the CPU, to keep the
    script under half its time limit."""
    ag = agent_sequence(n, device, scripted=agent, transport="native-tcp", native_server=True,
                        label="native, agent (native-tcp)", beside="the tcp agent's")
    return {"agent": ag}


@contextlib.contextmanager
def port_members(members, transport="native-tcp", settings=None):
    """``members`` port members on real sockets of ``transport``
    (``NativeTcpClientServer`` or, for "tcp", ``TcpClientServer``), the
    first a seed and the rest joined through it, with static failure
    detectors; their ``host:port`` targets. Every member and transport is
    shut down on exit."""
    from rapid_tpu_torch import ClusterBuilder, Settings
    from rapid_tpu_torch.messaging.native_tcp import NativeTcpClientServer
    from rapid_tpu_torch.messaging.tcp import TcpClientServer
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.types import Endpoint

    cls = {"native-tcp": NativeTcpClientServer, "tcp": TcpClientServer}[transport]
    if settings is None:
        settings = Settings(failure_detector_interval_ms=30, batching_window_ms=10)
    clusters, transports = [], []
    try:
        for i, port in enumerate(_free_ports(members)):
            addr = Endpoint.from_parts("127.0.0.1", port)
            t = cls(addr, settings)
            transports.append(t)
            b = (ClusterBuilder(addr).use_settings(settings)
                 .set_messaging_client_and_server(t, t)
                 .set_edge_failure_detector_factory(StaticFailureDetectorFactory(set())))
            clusters.append(b.start() if i == 0 else
                            b.join(clusters[0].listen_address, timeout=GATEWAY_WAIT_S))
        yield [str(c.listen_address) for c in clusters]
    finally:
        for c in clusters:
            c.shutdown()
        for t in transports:
            t.shutdown()


def run_cli(main, argv):
    """``main(argv)`` with its standard output and error captured: its exit
    code, both texts and its wall in ms."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue(), (time.perf_counter() - t0) * 1e3


def status_clis(targets, card):
    """``python -m rapid_tpu_torch.cli.statusz`` and ``cli.slo`` against live
    port members: statusz exits 0 and names exactly one configuration id
    across the members, slo exits 0 with each member's "no SLO plane"
    line."""
    from rapid_tpu_torch.cli import slo, statusz

    rc, out, err, statusz_ms = run_cli(statusz.main, targets)
    ids = set(re.findall(r"config=(-?\d+)", out))
    assert rc == 0 and err == "" and len(ids) == 1 and out.count("config=") == len(targets), \
        f"statusz: rc {rc}, ids {ids}:\n{out}{err}"
    slo_rc, slo_out, slo_err, slo_ms = run_cli(slo.main, targets)
    off = slo_out.count("(no SLO plane -- settings.slo.enabled is off)")
    assert slo_rc == 0 and slo_err == "" and off == len(targets), \
        f"slo: rc {slo_rc}:\n{slo_out}{slo_err}"
    print(f"native, statusz and slo over {len(targets)} members: statusz rc {rc}, one "
          f"configuration id {ids.pop()}, {statusz_ms:.1f} ms; slo rc {slo_rc}, "
          f"{off} \"no SLO plane\" lines, {slo_ms:.1f} ms ({card})", flush=True)
    return {"statusz_rc": rc, "statusz_ms": statusz_ms, "slo_rc": slo_rc, "slo_ms": slo_ms}


def native_scrape(card, members=SCRAPE_MEMBERS):
    """(e) ``members`` port members on ``NativeTcpClientServer`` with
    profiling on, scraped over real sockets with
    ``ClusterStatusRequest(include_history=8)`` by a native-transport client
    and folded with ``profiling.cluster_timeseries``: one series map a
    member, each holding that member's own counters (series labelled with
    its endpoint) and at least two history snapshots. Then the statusz and
    slo CLIs against the same members (``status_clis``)."""
    from rapid_tpu_torch import Settings
    from rapid_tpu_torch.messaging.native_tcp import NativeTcpClientServer
    from rapid_tpu_torch.profiling import cluster_timeseries
    from rapid_tpu_torch.settings import ProfilingSettings
    from rapid_tpu_torch.types import ClusterStatusRequest, Endpoint

    settings = Settings(failure_detector_interval_ms=30, batching_window_ms=10,
                        profiling=ProfilingSettings(enabled=True, history_interval_ms=50))
    t0 = time.perf_counter()
    with port_members(members, "native-tcp", settings) as targets:
        scraper = NativeTcpClientServer(Endpoint.from_parts("127.0.0.1", _free_ports(1)[0]))
        try:
            scraper.start()

            def scrape(history):
                return [scraper.send_message(Endpoint.from_string(target), ClusterStatusRequest(
                    sender=scraper.address, include_history=history)).result(GATEWAY_WAIT_S)
                    for target in targets]

            for _ in range(3):  # status calls tick each member's history ring
                scrape(0)
                time.sleep(0.1)
            t1 = time.perf_counter()
            replies = scrape(8)
            scrape_ms = (time.perf_counter() - t1) * 1e3
        finally:
            scraper.shutdown()
        clis = status_clis(targets, card)
    assert {r.membership_size for r in replies} == {members}, [r.membership_size for r in replies]
    cluster = cluster_timeseries(replies)
    assert set(cluster) == set(targets), sorted(cluster)
    rows = {}
    for reply in replies:
        node = str(reply.sender)
        series = cluster[node]
        own = [name for name in series if f"node={node}" in name]
        snaps = [pts for name, pts in series.items()
                 if name.startswith("profile.history_snapshots")]
        assert own and snaps and len(snaps[0]) >= 2, (node, sorted(series))
        rows[node] = {"series": len(series), "own_series": len(own),
                      "history_lines": len(reply.history), "snapshots": len(snaps[0])}
    print(f"native, scrape: {members} port members on native-tcp, cluster_timeseries of "
          f"{len(cluster)} members {rows}; the history scrape {scrape_ms:.3f} ms, the phase "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return {"members": rows, "scrape_ms": scrape_ms, "clis": clis}


# --------------------------------------------------------------------- #
# The gRPC transport: the port's own HTTP/2, HPACK and gRPC framing
# (messaging/http2.py) under GrpcServer / GrpcClient (host Python; no kernel)
# --------------------------------------------------------------------- #

GRPC_FRAMES = os.path.join(os.path.dirname(WIRE_FRAMES), "torch_grpc_frames.json")
GRPC_REPS = 1  # the 100k JoinResponse's calls on each transport
GRPC_JOINERS = 20  # tests/test_grpc_transport.py::test_concurrent_join_wave_through_one_seed


def grpc_golden(card):
    """(a) The port's frame reader and HPACK decoder replay every captured
    direction of ``tests/golden/torch_grpc_frames.json`` (grpcio's client
    against JAX's and the port's server, grpcio's server): the recorded
    frames and header blocks, exactly; the ``-bin`` value grpcio's client
    sent the port's server is the base64 of the recorded bytes, and its
    Huffman code stands in the captured bytes."""
    import base64

    from rapid_tpu_torch.messaging import http2

    with open(GRPC_FRAMES) as f:
        doc = json.load(f)
    frames = blocks = 0
    for server, capture in sorted(doc["captures"].items()):
        for side in ("client", "server"):
            recorded = capture[side]
            got = decode_capture(bytes.fromhex(recorded["hex"]), client_side=side == "client")
            assert got["frames"] == recorded["frames"], f"grpc: {server} {side}: frames differ"
            assert got["blocks"] == recorded["blocks"], f"grpc: {server} {side}: headers differ"
            frames += len(got["frames"])
            blocks += len(got["blocks"])
    key, value = doc["bin_metadata"]
    client = doc["captures"]["rapid_tpu_torch"]["client"]
    coded = base64.b64encode(bytes.fromhex(value)).rstrip(b"=")
    sent = [h for b in client["blocks"] for h in b["headers"] if h[0] == key]
    assert sent == [[key, coded.decode()]], sent
    assert http2.huffman_encode(coded).hex() in client["hex"], "no Huffman-coded -bin value"
    print(f"grpc (a): the port's frame reader and HPACK decoder give all {frames} frames and "
          f"{blocks} header blocks of {len(doc['captures'])} captures of grpcio "
          f"{doc['grpcio']} exactly, a Huffman-coded -bin value among them ({card})", flush=True)
    return {"frames": frames, "blocks": blocks}


class AnswerService:
    """A membership service stand-in that answers every request with one
    prebuilt reply."""

    def __init__(self, reply):
        self.reply = reply

    def handle_message(self, msg):
        from rapid_tpu_torch.runtime.futures import Promise

        promise = Promise()
        promise.set_result(self.reply)
        return promise


def grpc_join_response(card, reps=GRPC_REPS):
    """(b) The 100k ``JoinResponse`` of ``tests/golden/torch_proto_frames.json``
    (4 099 619 B in proto3) over one RPC: a port ``GrpcServer`` whose service
    answers it, called by a port ``GrpcClient`` over 127.0.0.1 with a
    ``JoinMessage``; each call's wall split into the server's encode, the
    client's decode and the transfer (the rest), with the DATA frames, the
    client's WINDOW_UPDATEs and the server's flow-control stalls. Beside it
    the same reply over the port's ``TcpClientServer`` and
    ``NativeTcpClientServer`` (msgpack). Medians of ``reps``; every reply
    equal to the one sent."""
    sys.path.insert(0, os.path.dirname(WIRE_FRAMES))
    import torch_wire_fixtures as fx

    from rapid_tpu_torch import Settings
    from rapid_tpu_torch.messaging.grpc_transport import GrpcClient, GrpcServer
    from rapid_tpu_torch.messaging.native_tcp import NativeTcpClientServer
    from rapid_tpu_torch.messaging.tcp import TcpClientServer
    from rapid_tpu_torch.types import Endpoint, JoinMessage, NodeId

    with open(PROTO_FRAMES) as f:
        spec = next(f for f in json.load(f)["frames"] if f["name"] == PROTO_BIG)
    big = fx.message(spec, fx.port_wire())
    settings = Settings(join_message_timeout_ms=int(GATEWAY_WAIT_S * 1e3), message_retries=0)
    eps = [Endpoint.from_parts("127.0.0.1", port) for port in _free_ports(6)]
    request = JoinMessage(sender=eps[1], node_id=NodeId(1, 2), ring_numbers=tuple(range(10)),
                          configuration_id=-1)
    runs = {}
    server, client = GrpcServer(eps[0]), GrpcClient(eps[1], settings)
    server.set_membership_service(AnswerService(big))
    server.start()
    try:
        calls = []
        for _ in range(reps):
            before_s, before_c = dict(server.stats), dict(client.stats)
            t0 = time.perf_counter()
            got = client.send_message(eps[0], request).result(GATEWAY_WAIT_S)
            wall = (time.perf_counter() - t0) * 1e3
            assert got == big, "grpc: the 100k JoinResponse arrived changed"
            sd, cd = _diff(server.stats, before_s), _diff(client.stats, before_c)
            calls.append({"wall_ms": wall, "encode_ms": sd["encode_ms"],
                          "decode_ms": cd["decode_ms"],
                          "transfer_ms": wall - sd["encode_ms"] - cd["decode_ms"],
                          "data_frames": sd["DATA out"],
                          "window_updates": cd.get("WINDOW_UPDATE out", 0),
                          "stalls": sd.get("stalls", 0)})
        runs["grpc"] = {k: statistics.median(c[k] for c in calls) for k in calls[0]}
    finally:
        client.shutdown()
        server.shutdown()
    for (name, cls), (srv_ep, cli_ep) in zip(
            (("tcp", TcpClientServer), ("native-tcp", NativeTcpClientServer)),
            ((eps[2], eps[3]), (eps[4], eps[5]))):
        srv, cli = cls(srv_ep, settings), cls(cli_ep, settings)
        srv.set_membership_service(AnswerService(big))
        srv.start()
        try:
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                got = cli.send_message(srv_ep, request).result(GATEWAY_WAIT_S)
                walls.append((time.perf_counter() - t0) * 1e3)
                assert got == big, f"{name}: the 100k JoinResponse arrived changed"
            runs[name] = {"wall_ms": statistics.median(walls)}
        finally:
            cli.shutdown()
            srv.shutdown()
    g = runs["grpc"]
    print(f"grpc (b), {PROTO_BIG} over one RPC: wall {g['wall_ms']:.1f} ms = encode "
          f"{g['encode_ms']:.1f} + transfer {g['transfer_ms']:.1f} + decode {g['decode_ms']:.1f} "
          f"ms; {g['data_frames']:.0f} DATA frames, {g['window_updates']:.0f} WINDOW_UPDATEs, "
          f"{g['stalls']:.0f} flow-control stalls; the same reply over tcp "
          f"{runs['tcp']['wall_ms']:.1f} ms, native-tcp {runs['native-tcp']['wall_ms']:.1f} ms "
          f"(msgpack) (medians of {reps}; equal replies) ({card})", flush=True)
    return runs


def _grpc_member(i, ports, settings, blacklist, seed=None, timeout=GATEWAY_WAIT_S):
    """Port member ``i`` on the port's gRPC transport at ``ports[i]``, with a
    static FD over ``blacklist``: a seed, or joined through ``seed`` within
    ``timeout`` s."""
    from rapid_tpu_torch import ClusterBuilder
    from rapid_tpu_torch.messaging.grpc_transport import GrpcClient, GrpcServer
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.types import Endpoint

    addr = Endpoint.from_parts("127.0.0.1", ports[i])
    builder = (ClusterBuilder(addr).use_settings(settings)
               .set_messaging_client_and_server(GrpcClient(addr, settings), GrpcServer(addr))
               .set_edge_failure_detector_factory(StaticFailureDetectorFactory(blacklist)))
    return builder.start() if seed is None else builder.join(seed, timeout=timeout)


def _until_agreed(clusters, size, timeout=GATEWAY_WAIT_S):
    """Wait until every member holds ``size`` members; assert one member
    list (by text: members may be of either package) and one configuration
    id, and return that id."""
    deadline = time.time() + timeout
    while time.time() < deadline and not all(c.get_membership_size() == size for c in clusters):
        time.sleep(0.02)
    lists = {tuple(str(e) for e in c.get_memberlist()) for c in clusters}
    ids = {c.get_current_configuration_id() for c in clusters}
    assert [c.get_membership_size() for c in clusters] == [size] * len(clusters), \
        [c.get_membership_size() for c in clusters]
    assert len(lists) == 1 and len(ids) == 1, (len(lists), ids)
    return ids.pop()


def grpc_cluster(card, joiners=GRPC_JOINERS, agree_s=GATEWAY_WAIT_S):
    """(c) A live cluster on the port's gRPC transport with
    ``tests/test_grpc_transport.py``'s join-wave settings (FD 100 ms,
    batching 50 ms, fallback 500 ms, ``GATEWAY_SETTINGS``): a seed and
    ``joiners`` concurrent joiners through it, every parked join answered
    without a thread held, until all agree on one member list and
    configuration id; then one member crashed (static FD blacklist) until the
    rest agree again, each agreement within ``agree_s`` s."""
    from rapid_tpu_torch import Settings

    settings = Settings(**GATEWAY_SETTINGS)
    ports, blacklist = _free_ports(joiners + 1), set()
    t0 = time.perf_counter()
    clusters = [_grpc_member(0, ports, settings, blacklist)]
    errors, lock = [], threading.Lock()

    def join(i):
        try:
            member = _grpc_member(i, ports, settings, blacklist, clusters[0].listen_address)
            with lock:
                clusters.append(member)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=join, args=(i,)) for i in range(1, joiners + 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(GATEWAY_WAIT_S)
        assert not errors and not any(t.is_alive() for t in threads), errors
        joined_id = _until_agreed(clusters, joiners + 1, agree_s)
        wave_ms = (time.perf_counter() - t0) * 1e3
        victim = clusters.pop()
        blacklist.add(victim.listen_address)
        t1 = time.perf_counter()
        victim.shutdown()
        crashed_id = _until_agreed(clusters, joiners, agree_s)
        crash_ms = (time.perf_counter() - t1) * 1e3
    finally:
        for c in clusters:
            c.shutdown()
    print(f"grpc (c), a live cluster on the port's gRPC: a seed and {joiners} concurrent "
          f"joiners agree on one member list, configuration id {joined_id}, in "
          f"{wave_ms:.1f} ms; one crashed, the {joiners} left agree on {crashed_id} in "
          f"{crash_ms:.1f} ms ({card})", flush=True)
    return {"wave_ms": wave_ms, "crash_ms": crash_ms, "joined_id": joined_id,
            "crashed_id": crashed_id}


def grpc_agent(card):
    """(d) ``python -m rapid_tpu_torch.cli.agent --transport grpc`` in a child
    process joins a port seed on gRPC (in this process), logs a membership
    of 2 at the seed's configuration id, and leaves on SIGINT with exit 0."""
    from rapid_tpu_torch import Settings

    settings = Settings(**GATEWAY_SETTINGS)
    ports = _free_ports(2)
    seed = _grpc_member(0, ports, settings, set())
    t0 = time.perf_counter()
    child = _AgentChild(["--transport", "grpc", "--listen-address", f"127.0.0.1:{ports[1]}",
                         "--seed-address", str(seed.listen_address), "--fd-interval-ms", "100"])
    try:
        _, _, line = child.wait("membership size=2 ")
        join_ms = (time.perf_counter() - t0) * 1e3
        agent_id = int(re.search(r"config=(-?\d+)", line).group(1))
        seed_id = seed.get_current_configuration_id()
        assert agent_id == seed_id and seed.get_membership_size() == 2, (agent_id, seed_id)
        child.proc.send_signal(signal.SIGINT)
        rc = child.proc.wait(timeout=60)
        assert rc == 0, f"the grpc agent exited {rc}"
    finally:
        child.close()
        seed.shutdown()
    print(f"grpc (d), the agent on --transport grpc: joined the port seed at configuration "
          f"id {agent_id} (the seed's) in {join_ms:.1f} ms from its start, exit {rc} on "
          f"SIGINT ({card})", flush=True)
    return {"join_ms": join_ms, "configuration_id": agent_id, "rc": rc}


def grpc_phase(card):
    """The gRPC transport's phase: (a)-(d) above."""
    t0 = time.perf_counter()
    out = {"golden": grpc_golden(card), "join_response_100k": grpc_join_response(card),
           "cluster": grpc_cluster(card), "agent": grpc_agent(card)}
    print(f"grpc phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------- #
# 22. the scenario battery and the paper's experiments (host and card)
# --------------------------------------------------------------------- #

# the 1M-member scenario the phase runs at full size: flip-flop-join-1m, the
# most demanding of the 1M trio (capacity 1 001 000, 1000 joiners, view
# changes with joins); crash-1m and one-way-loss-1m run in ``python -m
# rapid_tpu_torch.cli.scenarios --scale-1m`` on the card, to keep the script
# within half its time limit
SCENARIOS_1M = ("flip-flop-join-1m",)
# the record fields that must hold, each True, where a record has it
SCENARIO_TRUE = ("cut_ok", "config_id_ok", "config_id_parity", "cell_evicted_ok",
                 "parent_rounds_ok", "metastable_recovery_ok", "fast_alerts_cleared",
                 "identities_retained")
# the port's CPU path against the card: (label, scenario function, parameters)
SCENARIO_CROSS_CHECKS = (("crash-1k", "scenario_crash",
                          {"n": 1000, "n_fail": 1, "seed": 100,
                           "label": "1k virtual nodes, single crash-stop fault"}),
                         ("one-way-loss, n 1000", "scenario_one_way_loss",
                          {"n": 1000, "n_fail": 10, "seed": 300}))
JOIN_WAVE_N = 100_000
JOIN_WAVE_FRACTION = 0.01
# BASELINE.md's timing-conflicts table: skew -> conflicts (= stalls) of 18
FIG11_TABLE = {0: 0, 2: 0, 5: 6, 9: 18}
FIG11_SKEWS = (9,)


def scenario_misses(rec):
    """Which of a record's checks fail, as text (none: an empty list)."""
    misses = [f"{key} {rec[key]!r}" for key in SCENARIO_TRUE if key in rec and rec[key] is not True]
    if "hierarchy" in rec and rec["hierarchy"]["fingerprint_ok"] is not True:
        misses.append("hierarchy fingerprint_ok false")
    for key in ("lost_acked_writes", "spurious_view_changes"):
        if rec.get(key, 0) != 0:
            misses.append(f"{key} {rec[key]}")
    if rec.get("violations", []) != []:
        misses.append(f"violations {rec['violations']}")
    return misses


@contextlib.contextmanager
def _timed_calls(owner, attr, into):
    """While open, ``owner.attr`` (a function or method) adds its calls' host
    seconds to ``into[attr]`` and their count to ``into[attr + "_calls"]``."""
    original = getattr(owner, attr)
    into.setdefault(attr, 0.0)
    into.setdefault(attr + "_calls", 0)

    @functools.wraps(original)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            into[attr] += time.perf_counter() - t0
            into[attr + "_calls"] += 1

    setattr(owner, attr, timed)
    try:
        yield into
    finally:
        setattr(owner, attr, original)


def run_registry_scenario(scenarios, kernels, name, device):
    """One registered scenario through ``scenarios.run_scenario`` on
    ``device``, with its kernel launches (the change of ``kernels.LAUNCHES``
    by name), its whole host wall, and its host seconds split by what it
    called: simulator builds, ``run_until_decision`` (of it, the view
    changes: the simulators' "view_change" spans), the probe-drop masks and
    ``recomputed_config_id``."""
    from rapid_tpu_torch.observability import global_tracer
    from rapid_tpu_torch.sim import driver

    split = {}
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for owner, attr in ((driver.Simulator, "__init__"),
                            (driver.Simulator, "run_until_decision"),
                            (driver.Simulator, "_probe_drop_mask"),
                            (scenarios, "recomputed_config_id")):
            stack.enter_context(_timed_calls(owner, attr, split))
        rec = scenarios.run_scenario(name, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    view_changes = [s for s in global_tracer().collect_spans()
                    if s.name == "view_change" and s.plane == "sim" and s.wall_start_s >= t0]
    split = {"build_s": split["__init__"], "builds": split["__init___calls"],
             "decide_s": split["run_until_decision"] - sum(s.wall_ms for s in view_changes) / 1e3,
             "dispatch_calls": split["run_until_decision_calls"],
             "view_change_s": sum(s.wall_ms for s in view_changes) / 1e3,
             "view_changes": len(view_changes),
             "probe_drop_mask_s": split["_probe_drop_mask"],
             "probe_drop_masks": split["_probe_drop_mask_calls"],
             "recomputed_config_id_s": split["recomputed_config_id"]}
    return {"record": rec, "launches": _diff(dict(kernels.LAUNCHES), before),
            "seconds": seconds, "split": split}


def _scenario_line(name, run, card):
    split = run["split"]
    extra = ""
    if split["builds"] or split["dispatch_calls"]:
        extra = (f"; host split: build {split['build_s']:.3f} s ({split['builds']}), decisions "
                 f"{split['decide_s']:.3f} s ({split['dispatch_calls']} run_until_decision calls), "
                 f"view changes {split['view_change_s']:.3f} s ({split['view_changes']}), "
                 f"probe-drop masks {split['probe_drop_mask_s']:.3f} s "
                 f"({split['probe_drop_masks']}), recomputed_config_id "
                 f"{split['recomputed_config_id_s']:.3f} s")
    print(f"scenario {name} ({card}): {json.dumps(run['record'])}; launches {run['launches']}"
          f"; {run['seconds']:.3f} s in all{extra}", flush=True)


def _comparable(rec):
    """A record as JSON, without ``wall_s`` and the registry's name."""
    return json.loads(json.dumps({k: v for k, v in rec.items() if k not in ("wall_s", "scenario")}))


def start_message_load():
    """``python -m rapid_tpu_torch.experiments.message_load`` at its
    defaults in a child process (host Python, no card), started before the
    live planes phase, whose single thread of host work it overlaps with its
    own ~40 s on another core; ``scenarios_phase`` reads it. Killed at exit
    if still running. Returns (process, start time, [end time]), the end
    time set when the child exits."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "rapid_tpu_torch.experiments.message_load"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    ended = []
    threading.Thread(target=lambda: (proc.wait(), ended.append(time.perf_counter())),
                     daemon=True).start()
    return proc, time.perf_counter(), ended


def scenarios_phase(card, kernels, zone_churn, message_load_child):
    """The port's scenario battery (``rapid_tpu_torch.cli.scenarios``) on the
    card, at the registry's sizes: every ``BATTERY`` scenario, corpus plans
    included, and ``SCENARIOS_1M``, each through ``run_scenario``,
    each printed with its record, its kernel launches and its host split,
    each record's every check held (``scenario_misses``). hierarchy-zone-churn
    is the planes phase's run (``zone_churn``: its record and launches), not
    a second one. Then crash-1k and one-way-loss at 1000 on the port's CPU
    path, each record equal to the card's in every field but ``wall_s``; and
    the experiments: ``join_wave`` at 100k with a 1% wave,
    ``message_load`` at its defaults (host code: ``message_load_child``'s
    output, ``start_message_load``) with its test's assertions, and
    ``fig11_conflict_sweep``'s rows of ``FIG11_SKEWS``, each equal to
    BASELINE.md's table. Returns every result."""
    from rapid_tpu_torch.cli import scenarios
    from rapid_tpu_torch.experiments import fig11_conflict_sweep, join_wave

    t_phase = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    runs = {}
    for name in scenarios.BATTERY + list(SCENARIOS_1M):
        if name == "hierarchy-zone-churn":
            run = {"record": zone_churn["record"], "launches": zone_churn["launches"],
                   "seconds": zone_churn["record"]["wall_s"], "reused": "planes phase",
                   "split": {"builds": 0, "dispatch_calls": 0}}
        else:
            run = run_registry_scenario(scenarios, kernels, name, device)
        runs[name] = run
        _scenario_line(name, run, card)
        misses = scenario_misses(run["record"])
        assert not misses, f"scenario {name}: {'; '.join(misses)}"
    for name in ("serving-sawtooth", "overload-recover"):
        # the placement map's builds and updates launch the kernel
        assert runs[name]["launches"].get("placement_topr", 0) > 0, (name, runs[name]["launches"])

    cross = {}
    for label, fn_name, params in SCENARIO_CROSS_CHECKS:
        fn = getattr(scenarios, fn_name)
        card_rec = runs[label]["record"] if label in runs else fn(**params, device=device)
        got, want = _comparable(card_rec), _comparable(fn(**params, device="cpu"))
        assert got == want, f"cross-check scenario {label}: card {got} != cpu {want}"
        cross[label] = want
        print(f"cross-check scenario {label}: card == cpu in every field but wall_s "
              f"(virtual {want['virtual_ms']} ms, cut_ok {want['cut_ok']}, config_id_ok "
              f"{want['config_id_ok']})", flush=True)

    t0 = time.perf_counter()
    before = dict(kernels.LAUNCHES)
    wave = join_wave.run_size(JOIN_WAVE_N, JOIN_WAVE_FRACTION, SEED, device)
    wave["launches"] = _diff(dict(kernels.LAUNCHES), before)
    wave["seconds"] = time.perf_counter() - t0
    assert wave["admitted_ok"] and wave["virtual_ms"] == 2 * 1000 + 100, wave
    print(f"experiment join_wave ({card}): {json.dumps(wave)}", flush=True)

    proc, t0, ended = message_load_child
    out, err = proc.communicate(timeout=600)
    load_s = (ended[0] if ended else time.perf_counter()) - t0
    assert proc.returncode == 0, f"message_load exited {proc.returncode}: {err[-2000:]}"
    load = {line["strategy"]: line for line in map(json.loads, out.splitlines())}
    assert list(load) == ["unicast", "gossip", "gossip-pushpull"], list(load)
    uni, gos = load["unicast"]["per_type_totals"], load["gossip"]["per_type_totals"]
    assert uni["BatchedAlertMessage"] == gos["BatchedAlertMessage"], load
    assert uni["FastRoundPhase2bMessage"] == gos["FastRoundPhase2bMessage"], load
    assert "GossipEnvelope" not in uni and gos["GossipEnvelope"] > 0, load
    assert load["gossip"]["mean_msgs"] > load["unicast"]["mean_msgs"], load
    print(f"experiment message_load (host, {load_s:.1f} s in its own process): "
          + "; ".join(json.dumps(v) for v in load.values()), flush=True)

    fig11 = {}
    before = dict(kernels.LAUNCHES)
    for skew in FIG11_SKEWS:
        t0 = time.perf_counter()
        conflicts, stalls, trials = fig11_conflict_sweep.sweep_row(skew, device)
        assert conflicts == stalls == FIG11_TABLE[skew] and trials == 18, (skew, conflicts, stalls)
        fig11[skew] = {"conflicts": conflicts, "stalls": stalls, "trials": trials,
                       "seconds": time.perf_counter() - t0}
        print(f"experiment fig11_conflict_sweep ({card}): skew {skew}: conflicts "
              f"{conflicts}/{trials}, stalls {stalls}/{trials}, all converged (BASELINE.md's "
              f"row), {fig11[skew]['seconds']:.1f} s", flush=True)
    fig11_launches = _diff(dict(kernels.LAUNCHES), before)
    seconds = time.perf_counter() - t_phase
    print(f"scenarios phase {seconds:.1f} s ({card}): {len(runs)} scenarios, every check true",
          flush=True)
    return {"runs": runs, "cross_checks": cross, "join_wave": wave, "message_load": load,
            "message_load_s": load_s,
            "fig11": fig11, "fig11_launches": fig11_launches, "seconds": seconds}


# --------------------------------------------------------------------- #
# 23. the tools and examples (host and card)
# --------------------------------------------------------------------- #

LB_BACKENDS, LB_FAIL, LB_SEED = 50, 10, 23  # the paper's Fig. 13 shape
SWARM_AGENT_N, SWARM_AGENT_CRASH_PERCENT, SWARM_AGENT_SEED = 1000, 1.0, 42
PERFSCOPE_N = N_NODES
TOOL_KERNELS = ("fd_phase_fused", "placement_topr")


def load_balancer_run(card, kernels, device="cuda"):
    """(a): Fig. 13 through ``examples.load_balancer.run_scenario``; its
    four properties held, the launches of TOOL_KERNELS in the gateway's
    warm-up (``warm_compile`` runs a decision of each branch) and, counted
    from 0 after it, in the run: the router's join and the crash."""
    from rapid_tpu_torch.examples import load_balancer
    from rapid_tpu_torch.messaging.gateway import SwarmGateway

    warm, warm_launches = SwarmGateway.warm, {}

    def warm_then_count(gateway, *args, **kwargs):
        warm(gateway, *args, **kwargs)
        warm_launches.update({name: kernels.LAUNCHES.get(name, 0) for name in TOOL_KERNELS})
        kernels.reset_launches()

    kernels.reset_launches()
    SwarmGateway.warm = warm_then_count
    t0 = time.perf_counter()
    try:
        out = load_balancer.run_scenario(LB_BACKENDS, LB_FAIL, LB_SEED, quiet=True,
                                         device=device)
    finally:
        SwarmGateway.warm = warm
    wall_s = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES.get(name, 0) for name in TOOL_KERNELS}
    checks = load_balancer.holds(out)
    print(f"tools and examples (a), load balancer: {LB_BACKENDS} backends, {LB_FAIL} failed "
          f"at once (seed {LB_SEED}), the swarm on {device}: {out['view_changes']} view "
          f"change(s), cut {len(out['cut'])} (the victims: {out['cut'] == out['victims']}), "
          f"{len(out['dead_routes'])} routes to dead backends, {out['moved']}/{out['keys']} "
          f"keys moved, router id {out['config_id_router']}, swarm id "
          f"{out['config_id_swarm']}; wall {wall_s:.2f} s; launches in the run {launches}, "
          f"in the gateway's warm-up before it {warm_launches} ({card})", flush=True)
    assert all(checks.values()), f"load balancer: Fig. 13 does not hold: {checks}"
    return {"view_changes": out["view_changes"], "cut": len(out["cut"]),
            "cut_is_victims": out["cut"] == out["victims"],
            "dead_routes": len(out["dead_routes"]), "moved": out["moved"], "keys": out["keys"],
            "config_id_router": out["config_id_router"],
            "config_id_swarm": out["config_id_swarm"], "wall_s": wall_s,
            "launches": launches, "warm_launches": warm_launches, "checks": checks}


def swarm_agent_run(card, kernels, device="cuda"):
    """(b): ``examples.swarm_agent.run`` at 1000 virtual nodes, 1% crashed."""
    from rapid_tpu_torch.examples import swarm_agent

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = swarm_agent.run(SWARM_AGENT_N, SWARM_AGENT_CRASH_PERCENT, SWARM_AGENT_SEED,
                          device=device, quiet=True)
    wall_s = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES.get(name, 0) for name in TOOL_KERNELS}
    for row in out["steps"]:
        print(f"tools and examples (b), swarm_agent, {row['name']}: member id "
              f"{row['member_id']}, swarm id {row['swarm_id']}, member size "
              f"{row['member_size']}, swarm size {row['swarm_size']}, holds {row['ok']}",
              flush=True)
    print(f"tools and examples (b), swarm_agent: {SWARM_AGENT_N} virtual nodes, "
          f"{out['crashed']} crashed, the swarm on {device}; wall {wall_s:.2f} s; launches "
          f"{launches} ({card})", flush=True)
    assert out["ok"], f"swarm_agent: the member's and the swarm's ids differ: {out['steps']}"
    return {"steps": out["steps"], "crashed": out["crashed"], "wall_s": wall_s,
            "launches": launches}


def operator_tools_run(card, root, device="cuda"):
    """(c): ``cli.perfscope render`` over the profiler's ``json_snapshot`` of
    a profiled decision at PERFSCOPE_N on the card, and ``cli.tracecat`` over
    two port members' Chrome traces of one churn episode."""
    from rapid_tpu_torch.cli import perfscope, tracecat
    from rapid_tpu_torch.harness import ClusterHarness
    from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
    from rapid_tpu_torch.observability import Metrics, chrome_trace, json_snapshot
    from rapid_tpu_torch.profiling import PHASES
    from rapid_tpu_torch.settings import ProfilingSettings
    from rapid_tpu_torch.sim.driver import Simulator

    sim = Simulator(PERFSCOPE_N, seed=SEED, metrics=Metrics(), device=device).ready()
    prof = sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
    sim.crash(np.random.default_rng(SEED).choice(PERFSCOPE_N, PERFSCOPE_N // 100, replace=False))
    assert sim.run_until_decision(max_rounds=16, batch=16) is not None
    snapshot = os.path.join(root, "metrics.json")
    with open(snapshot, "w") as fh:
        json.dump(json_snapshot(sim.metrics), fh)
    rc, text, _, _ = run_cli(perfscope.main, ["render", snapshot])
    bars = [line for line in text.splitlines() if line.split() and line.split()[0] in PHASES]
    print(f"tools and examples (c), perfscope render over the profiled {PERFSCOPE_N} decision's "
          f"json_snapshot on {device} ({prof.attribution()}): rc {rc}, {len(bars)} phase bars "
          f"({card})", flush=True)
    for line in text.splitlines():
        print(f"  {line}", flush=True)
    assert rc == 0 and len(bars) == len(PHASES) == 4, (rc, text)

    h = ClusterHarness(seed=7, use_static_fd=False)
    try:
        blacklist = set()
        h.start_seed(0, fd=StaticFailureDetectorFactory(blacklist))
        h.join(1, fd=StaticFailureDetectorFactory(blacklist))
        h.join(2, fd=StaticFailureDetectorFactory(set()))
        h.wait_and_verify_agreement(3)
        victim = h.addr(2)
        services = [h.instances[h.addr(i)]._membership_service for i in (0, 1)]
        h.instances.pop(victim).shutdown()
        blacklist.add(victim)
        h.wait_and_verify_agreement(2, timeout_ms=1_200_000)
        traces = []
        for i, svc in enumerate(services):
            traces.append(os.path.join(root, f"node{i}.json"))
            with open(traces[-1], "w") as fh:
                json.dump(chrome_trace(svc.tracer), fh)
    finally:
        h.shutdown()
    merged_path = os.path.join(root, "merged.json")
    rc_cat, _, _, _ = run_cli(tracecat.main, [*traces, "-o", merged_path])
    with open(merged_path) as fh:
        merged = json.load(fh)["traceEvents"]
    processes = [e["args"]["name"] for e in merged
                 if e.get("ph") == "M" and e.get("name") == "process_name"]
    virtual = processes.count(tracecat.VIRTUAL_PROCESS_NAME)
    print(f"tools and examples (c), tracecat over 2 port members' Chrome traces: rc {rc_cat}, "
          f"{len(merged)} events, processes {processes}, {virtual} shared "
          f"'{tracecat.VIRTUAL_PROCESS_NAME}' process ({card})", flush=True)
    assert rc_cat == 0 and virtual == 1, (rc_cat, processes)
    return {"perfscope_rc": rc, "phase_bars": len(bars), "tracecat_rc": rc_cat,
            "merged_events": len(merged), "processes": processes}


SWEEP_SIZES = (1_000, 10_000, 100_000, 1_000_000)  # experiments/scaling_sweep.py's defaults
SWEEP_POINT_N = N_NODES  # the sweep phase's placement-and-handoff point


def scaling_sweep_phase(card, kernels, device="cuda"):
    """``rapid_tpu_torch.experiments.scaling_sweep`` on the card: its
    ``run_size`` at each of ``SWEEP_SIZES`` (seed 42, 1% crashed, the
    closed form: no FD kernel in the timed window), each size's JSON line,
    build seconds and launches, with no kernel built or loaded in the timed
    window; then the placement-and-handoff point at ``SWEEP_POINT_N``
    members through the same ``warmed_run`` (``sweep_point_run``: the cut,
    minimal motion, every handoff session completed), its moved partitions
    and ``placement_topr`` launches (the build at ``enable_placement``, then
    the view change)."""
    from rapid_tpu_torch.experiments import scaling_sweep

    lines, runs = [], {}
    for n in SWEEP_SIZES:
        details, t0 = {}, time.perf_counter()
        line = scaling_sweep.run_size(n, SEED, device, details=details)
        del details["sim"]
        details["phase_s"] = round(time.perf_counter() - t0, 2)
        assert line["cut_ok"] and line["virtual_ms"] == 11_100, line
        assert details["kernel_builds_steady"] == details["kernel_loads_steady"] == 0, details
        assert details["launches_steady"].get("fd_phase_fused", 0) == 0, details
        print(json.dumps(line), flush=True)
        print(f"scaling sweep, {n}: build {details['build_s']:.2f} s (the warm-up simulator), "
              f"warm-up decision {details['warmup_wall_s'] * 1000:.1f} ms, launches in the "
              f"timed window {details['launches_steady']}, kernel builds / loads there "
              f"{details['kernel_builds_steady']} / {details['kernel_loads_steady']}, "
              f"{details['phase_s']} s in all ({card})", flush=True)
        lines.append(line)
        runs[n] = details
    details, t0 = {}, time.perf_counter()
    point = sweep_point_run(SWEEP_POINT_N, SWEEP_PARTITIONS, device=device, details=details)
    versions = point["placement_versions"]
    assert versions[0] != versions[1] and point["moved"] == [len(point["moved_partitions"])]
    assert point["transfers"] == point["handoff"]["handoff.sessions_completed"] > 0, point
    topr = details["launches_warmup"].get("placement_topr", 0), details["launches_steady"].get(
        "placement_topr", 0)
    assert topr == (1, 1), topr
    print(f"scaling sweep, placement point: {SWEEP_POINT_N} members, {SWEEP_PARTITIONS} "
          f"partitions, handoff on: cut ok ({len(point['record']['cut'])}), "
          f"{point['moved']} partitions moved, sessions "
          f"{point['handoff']['handoff.sessions_completed']}/"
          f"{point['handoff']['handoff.sessions_started']}, virtual "
          f"{point['record']['virtual_time_ms']} ms, timed decision {details['wall_ms']:.1f} ms, "
          f"placement_topr launches {topr[0]} (enable_placement) + {topr[1]} (the view change), "
          f"{time.perf_counter() - t0:.1f} s in all ({card})", flush=True)
    return {"lines": lines, "runs": runs, "placement_point": {
        "wall_ms": details["wall_ms"], "moved": point["moved"], "handoff": point["handoff"],
        "placement_topr": list(topr), "virtual_ms": point["virtual_ms"]}}


def tools_examples_phase(card, kernels):
    """The tools and examples phase: (a)-(c) above, on the card."""
    import tempfile

    t0 = time.perf_counter()
    out = {"load_balancer": load_balancer_run(card, kernels),
           "swarm_agent": swarm_agent_run(card, kernels)}
    with tempfile.TemporaryDirectory(prefix="rapid-tools-") as root:
        out["operator_tools"] = operator_tools_run(card, root)
    print(f"tools and examples phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


THREEFRY_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                               "torch_threefry.json")
THREEFRY_SEEDS = (0, 3, 7, 42, 2**31 - 1)
THREEFRY_SHAPES = ((1, 1), (37, 10), (1000, 10))
THREEFRY_FOLD = 3  # the shard index folded into the vectors' second draw
# (rows, shards) of the main path's draws, key PRNGKey(SEED), K = 10: the
# scan round at 100k and 1M, and one call over the 8 shards of a 100k mesh
THREEFRY_DRAWS = ((N_NODES, None), (1_000_000, None), (N_NODES // 8, tuple(range(8))))
THREEFRY_WORDS = 400  # vectors up to this many words are kept whole, longer ones as digests
# the lossy decision of the golden file: 1% of members at ingress loss 0.5
THREEFRY_DECISION = {"n": 10_000, "seed": 3, "members": 100, "probability": 0.5,
                     "max_rounds": 64, "batch": 16}
# operations an element of threefry_draw takes, by the pipe that can issue
# them (csrc/threefry.cu's header counts them in the loop's SASS): the 20
# rotates, 21 xors and the float's shift-and-or only on the ALU's 64 lanes a
# clock an SM; those, the 27 fused adds and the float's subtract on the ALU
# and FMA pipes' 128 lanes together
THREEFRY_ALU_OPS_PER_ELEMENT = 42
THREEFRY_OPS_PER_ELEMENT = 70
TWO_PIPE_OPS_PER_S = 2 * INT32_OPS_PER_S  # both pipes: 132 SMs x 128 lanes x 1.98 GHz


def threefry_vector(key, draw):
    """A draw as the golden file keeps it: the split key's two words, the
    draw's shape, and its float32 bits as uint32 words (whole when short,
    else their SHA-256 over the little-endian bytes and the first 8)."""
    words = np.ascontiguousarray(np.asarray(draw, dtype=np.float32)).view("<u4")
    out = {"key": [int(w) for w in np.asarray(key)], "shape": list(words.shape),
           "sha256": hashlib.sha256(words.tobytes()).hexdigest(),
           "first": [int(w) for w in words.reshape(-1)[:8]]}
    if words.size <= THREEFRY_WORDS:
        out["words"] = [int(w) for w in words.reshape(-1)]
    return out


def threefry_cases():
    """Every (seed, rows, k, shards) draw the golden file holds: each seed
    and shape with and without the fold, then the main path's draws."""
    cases = [(seed, rows, k, fold) for seed in THREEFRY_SEEDS for rows, k in THREEFRY_SHAPES
             for fold in (None, (THREEFRY_FOLD,))]
    return cases + [(SEED, rows, 10, shards) for rows, shards in THREEFRY_DRAWS]


def threefry_decision(Simulator, **sim_kw):
    """The golden file's lossy decision on ``Simulator`` (either package's):
    its cut, configuration id, virtual time and the rounds it ran."""
    d = THREEFRY_DECISION
    sim = Simulator(d["n"], seed=d["seed"], **sim_kw)
    victims = np.sort(np.random.default_rng(d["seed"]).choice(d["n"], d["members"],
                                                              replace=False))
    sim.ingress_loss(victims, d["probability"])
    rec = sim.run_until_decision(d["max_rounds"], d["batch"])
    assert rec is not None, "the lossy decision was not reached"
    return {"cut": sorted(int(c) for c in rec.cut), "configuration_id": int(rec.configuration_id),
            "virtual_time_ms": int(rec.virtual_time_ms), "rounds": int(sim.metrics.get("rounds"))}


def _cold_ms(fn, flush, iters=11):
    """Device ms of ``fn`` right after ``flush`` is written (more bytes than
    the L2 holds, so nothing ``fn`` touches stays there): CUDA events around
    the call alone, the median over ``iters``."""
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def threefry_phase(kernels, threefry, Simulator, card, device, scan_walls, scan_launches):
    """``threefry_draw`` on the card: against its plain version at the main
    path's shapes, against the JAX package's vectors and digests
    (``THREEFRY_GOLDEN``), and timed cold and hot at [100_000, 10] beside
    its plain version, ``torch.rand`` of the same shape (the nearest single
    PyTorch call, though not the same function) and its bound; and the file's lossy
    decision on the card, whose words the FD kernel makes (``fd_phase_fused``
    48 times, ``threefry_draw`` never). Returns the kernel's entry for the
    kernels line (without ``launches``)."""
    with open(THREEFRY_GOLDEN) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    for rows, shards in THREEFRY_DRAWS:
        key, keys = threefry.prng_key(SEED).to(device), {}
        for halted in (False, True):  # a halted round keeps its key
            halt = torch.tensor(halted, device=device)
            want_key, want = threefry.draw_plain(key, rows, 10, shards, halt)
            got_key, got = kernels.threefry_draw(key, rows, 10, shards, halt=halt)
            torch.cuda.synchronize()
            assert torch.equal(got_key, want_key) and torch.equal(
                got.view(torch.int32), want.view(torch.int32)), (
                f"threefry_draw at [{rows}, 10], shards {shards}, halt {halted}, disagrees "
                f"with its plain version")
            assert torch.equal(got_key, key) == halted, (rows, shards, halted)
            keys[halted] = got_key.tolist()
        print(f"threefry, [{rows}, 10]{' over shards ' + str(list(shards)) if shards else ''}: "
              f"bit-identical to plain (tolerance 0) with the halt flag clear and set, key "
              f"{keys[False]} split, {keys[True]} kept", flush=True)
    got = [threefry_vector(*(t.cpu().numpy() for t in kernels.threefry_draw(
               threefry.prng_key(seed).to(device), rows, k, shards)))
           for seed, rows, k, shards in threefry_cases()]
    misses = _golden_misses(got, golden["vectors"])
    assert not misses, f"threefry_draw differs from {THREEFRY_GOLDEN}: " + "; ".join(misses[:5])
    kernels.reset_launches()
    t1 = time.perf_counter()
    decision = threefry_decision(Simulator, device=device)
    decision_ms = (time.perf_counter() - t1) * 1e3
    decision_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    misses = _golden_misses(decision, golden["decision"])
    assert not misses, f"the lossy decision differs from {THREEFRY_GOLDEN}: {misses[:5]}"
    # 3 dispatches of 16 rounds; the FD kernel splits the key and draws
    assert decision_launches == {"fd_phase_fused": 48}, decision_launches
    print(f"threefry, golden: {len(got)} vectors and digests equal the JAX package's; the "
          f"lossy decision ({THREEFRY_DECISION['n']} members, {THREEFRY_DECISION['members']} "
          f"at ingress loss {THREEFRY_DECISION['probability']}) cut {len(decision['cut'])}, "
          f"configuration id {decision['configuration_id']}, virtual "
          f"{decision['virtual_time_ms']} ms, {decision['rounds']} rounds == the JAX package's; "
          f"wall {decision_ms:.1f} ms (first on this size), launches {decision_launches} "
          f"({card})", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    sizes = {}
    # timed at the main path's shape alone: no round path launches it, and
    # the golden vectors hold it at [1M, 10]
    for rows in KERNEL_SIZES[:1]:
        key = threefry.prng_key(SEED).to(device)
        kernel = lambda: kernels.threefry_draw(key, rows, 10)  # noqa: E731
        plain = lambda: threefry.draw_plain(key, rows, 10)  # noqa: E731
        rand = lambda: torch.rand((rows, 10), device=device)  # noqa: E731
        t = {"cold_ms": _cold_ms(kernel, flush), "hot_ms": _time_ms(kernel),
             "plain_cold_ms": _cold_ms(plain, flush), "plain_hot_ms": _time_ms(plain),
             "torch_rand_cold_ms": _cold_ms(rand, flush), "torch_rand_hot_ms": _time_ms(rand)}
        elements = rows * 10
        ops_ms = max(THREEFRY_ALU_OPS_PER_ELEMENT * elements / INT32_OPS_PER_S,
                     THREEFRY_OPS_PER_ELEMENT * elements / TWO_PIPE_OPS_PER_S) * 1e3
        bytes_ms = (4 * elements + 4 * 8) / HBM_BYTES_PER_S * 1e3  # the draw out, keys in and out
        bound_ms = max(ops_ms, bytes_ms)
        sizes[f"{rows}x10"] = dict(
            t, max_abs_err=0, ms=t["cold_ms"], plain_ms=t["plain_cold_ms"], bound_ms=bound_ms,
            bound_us=bound_ms * 1e3, ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            share_of_bound=bound_ms / t["cold_ms"])
        print(f"threefry_draw [{rows}, 10] timed: "
              + ", ".join(f"{name} {ms * 1e3:.2f} us" for name, ms in t.items())
              + f"; bound {bound_ms * 1e3:.2f} us (operations {ops_ms * 1e3:.2f} us: "
              f"{THREEFRY_ALU_OPS_PER_ELEMENT} ALU ops an element at 64 lanes, "
              f"{THREEFRY_OPS_PER_ELEMENT} in all at 128; bytes {bytes_ms * 1e3:.2f} us), "
              f"{bound_ms / t['cold_ms']:.1%} of it cold ({card})", flush=True)
    del flush
    torch.cuda.empty_cache()
    print(f"threefry, scan decisions (100k, ingress loss 1.0): walls "
          f"{[round(w, 3) for w in scan_walls]} ms, median {statistics.median(scan_walls):.3f} ms, "
          f"threefry_draw launches {scan_launches['threefry_draw']}, fd_phase_fused's "
          f"{scan_launches['fd_phase_fused']} ({card})", flush=True)
    main_shape = sizes[f"{KERNEL_SIZES[0]}x10"]
    return {
        "name": "threefry_draw",
        "route": "cuda",
        "source": "rapid_tpu_torch/csrc/threefry.cu",
        # no Pallas kernel: jax.random's threefry in the round's XLA program
        "replaces": "rapid_tpu/sim/engine.py:575",
        # the FD kernels make the words on every round path (threefry.cuh);
        # this is the block the golden vectors hold
        "on_main_path": False,
        "path": "none: the golden vectors (the FD kernels draw on the round paths)",
        "launches_golden_decision": decision_launches.get("threefry_draw", 0),
        "match": True,
        "max_abs_err": 0,
        "ms": main_shape["ms"],
        "kernel_ms": main_shape["ms"],
        "hot_ms": main_shape["hot_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_us": main_shape["bound_us"],
        "bound_by": main_shape["bound_by"],
        "tolerance": 0,
        # no PyTorch call computes JAX's threefry; torch.rand of the same
        # shape (another generator) is timed beside it
        "library_ms": None,
        "torch_rand_ms": main_shape["torch_rand_cold_ms"],
        "sizes": sizes,
        "golden_decision": decision,
        "golden_vectors": len(got),
        "phase_s": time.perf_counter() - t0,
    }


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapid_tpu_torch import observability
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.settings import ProfilingSettings
    from rapid_tpu_torch.shard import engine as shard
    from rapid_tpu_torch.sim import classic, engine, fd_bench, kernels, threefry
    from rapid_tpu_torch.sim.driver import Simulator

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # seconds of each phase, printed on one line before the last
    phases, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phases[name] = round(now - mark[0], 1)
        mark[0] = now

    t0 = time.perf_counter()
    topr_builds = start_topr_builds()
    native_builds = start_native_builds()
    libs = kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in libs.values())})", flush=True)
    lap("kernel build")

    # --- the native host plane: (a) the g++ builds, (b) the hashes at 100k
    # and 1M, before any phase that synthesizes a cluster or builds a view
    native = {"build": native_build(card, native_builds), "hashes": native_hashes(card),
              "stress": native_stress(card)}
    lap("native (a), (b), (f)")

    # --- the simulator bridge, first in the process: warm_compile does the
    # process's first-time work, the pumps after it show what is left -------
    os.environ["RAPID_JITWATCH"] = "1"
    card_device = torch.device("cuda", torch.cuda.current_device())
    bridge = bridge_sequence(N_NODES, device, [card_device] * 4)
    lap("bridge")
    bridged_launches = {}
    for row in bridge["pumps"]:
        for name, count in row["launches"].items():
            bridged_launches.setdefault(name, []).append((row["name"], count))

    # --- the wire, then the socket gateway with a member in its own process
    wire = wire_phase(card)
    wire["proto"] = proto_phase(card)
    lap("wire and proto")
    gateway = gateway_sequence(N_NODES, card_device)
    _print_gateway(gateway, card)
    lap("gateway")
    gateway_launches = {}
    for row in gateway["steps"]:
        for name, count in row["pump_launches"].items():
            gateway_launches.setdefault(name, []).append((row["name"], count))

    # --- real port members: in process on the bridge, and an agent over TCP
    members = member_sequence(N_NODES, card_device, scripted=bridge)
    lap("member")
    agent = agent_sequence(N_NODES, card_device, scripted=gateway)
    lap("agent")
    # --- the native host plane: (c) the member's join on the numpy path
    # beside the member phase's (native), (d) the reactor's front door and
    # the native-tcp agent, (e) the scrape ------------------------------------
    native["member_join"] = native_member_join(N_NODES, card_device, card, members["pumps"][0])
    native["gateway"] = native_gateway(N_NODES, card_device, agent)
    native["scrape"] = native_scrape(card)
    lap("native (c)-(e)")
    # --- the gRPC transport: golden wire, the 100k reply, a live cluster,
    # the agent (host Python; no kernel) ----------------------------------
    grpc_result = grpc_phase(card)
    lap("grpc")
    # --- the protocol plane's live engines (host Python; no kernel), with
    # the message_load experiment (host Python too) in its own process ------
    message_load_child = start_message_load()
    live = live_planes_phase(card)
    lap("live planes")
    # --- the nemesis search and the forensics timeline (the sim harness's
    # simulators on the card) ----------------------------------------------
    search = search_phase(card)
    lap("search")
    # (run, launches) of the search's sim-harness runs: (c) the hunt, (d) the 100k probe
    search_launches = {}
    for run in ("sim_hunt", "wide_probe"):
        for name, count in search["walls"][run]["launches"].items():
            search_launches.setdefault(name, []).append((run, count))
    member_launches, agent_launches = {}, {}
    for rows, key, into in ((members["pumps"], "launches", member_launches),
                            (agent["steps"], "pump_launches", agent_launches)):
        for row in rows:
            for name, count in row[key].items():
                into.setdefault(name, []).append((row["name"], count))

    kernel_results = _kernel_phase(kernels, device)
    kernel_results["fd_phase_fused"] = _fused_phase(kernels, fd_bench, device)
    kernel_results["fd_phase_fused_windowed"] = _windowed_phase(kernels, fd_bench, engine, device)
    lap("kernels")

    # --- headline: closed-form branch --------------------------------------
    rng = np.random.default_rng(SEED)
    n_fail = N_NODES // 100

    def timed(fault_name, seed):
        """Warmed decision walls over TIMED_RUNS fresh simulators; kernel
        launch counts from the last run (reset just before it)."""
        walls = []
        for i in range(TIMED_RUNS):
            sim = Simulator(N_NODES, seed=seed + i, device=device).ready()
            fault = sim.crash if fault_name == "crash" else (
                lambda v, sim=sim: sim.ingress_loss(v, 1.0))
            victims = rng.choice(N_NODES, n_fail, replace=False)
            kernels.reset_launches()
            rec, ms = _decide(sim, victims, fault)
            launches = dict(kernels.LAUNCHES)
            walls.append(ms)
        return rec, walls, launches

    warm = Simulator(N_NODES, seed=SEED, device=device)
    _, warm_ms = _decide(warm, rng.choice(N_NODES, n_fail, replace=False), warm.crash)
    rec, head_walls, headline_launches = timed("crash", SEED + 4444)
    counted = Simulator(N_NODES, seed=SEED + 1, device=device).ready()
    counted.crash(rng.choice(N_NODES, n_fail, replace=False))
    syncs = _count_syncs(lambda: counted.run_until_decision(max_rounds=16, batch=16))
    print(f"headline (closed form): {N_NODES} members, {n_fail} crashed, cut ok, "
          f"virtual {rec.virtual_time_ms} ms, warmed wall median "
          f"{statistics.median(head_walls):.3f} ms max {max(head_walls):.3f} ms over "
          f"{TIMED_RUNS} runs {[round(w, 3) for w in head_walls]} (first run "
          f"{warm_ms:.3f} ms), kernel launches {headline_launches}, "
          f"synchronizing CUDA calls per decision: {syncs}", flush=True)

    # --- scan path: random ingress loss, FD phase in the CUDA kernel --------
    counted = Simulator(N_NODES, seed=SEED + 2, device=device).ready()
    counted.ingress_loss(rng.choice(N_NODES, n_fail, replace=False), 1.0)
    scan_syncs = _count_syncs(lambda: counted.run_until_decision(max_rounds=16, batch=16))
    rec, scan_walls, scan_launches = timed("ingress_loss", SEED + 5555)
    assert scan_launches["fd_phase_fused"] >= 11, scan_launches
    assert scan_launches["fd_phase_u8"] == 0, scan_launches
    assert scan_launches["fd_phase_fused_windowed"] == 0, scan_launches
    # a decision syncs once per dispatch for the decision words; host uploads
    # are queued from pinned memory and do not block. At most 6 in the closed
    # form and 7 on the scan path, the counts when uploads blocked.
    assert syncs <= 6 and scan_syncs <= 7, (syncs, scan_syncs)
    print(f"scan path (ingress loss 1.0): cut ok, virtual {rec.virtual_time_ms} ms, "
          f"warmed wall median {statistics.median(scan_walls):.3f} ms max "
          f"{max(scan_walls):.3f} ms over {TIMED_RUNS} runs "
          f"{[round(w, 3) for w in scan_walls]}, kernel launches {scan_launches}, "
          f"synchronizing CUDA calls per decision: {scan_syncs}", flush=True)

    lap("headline and scan")
    # --- the random-loss draw: JAX's threefry bits on the card ---------------
    threefry_line = threefry_phase(kernels, threefry, Simulator, card, device, scan_walls,
                                   scan_launches)
    lap("threefry")
    # --- the windowed policy's decisions, and the classic fallback ----------
    windowed = _windowed_decisions(Simulator, engine, kernels, rng, device)
    fallback = _classic_fallback(Simulator, engine, classic, kernels, device)

    _cross_check(Simulator, engine, device)
    lap("windowed, classic, cross-check")

    # --- telemetry, speculation, profiling ---------------------------------
    planes = {"speculation": _speculation_pairs(Simulator, rng, device),
              "timed_window": _timed_windows(Simulator, observability, jitwatch,
                                             ProfilingSettings, rng, device),
              "profiling": _profiling(Simulator, engine, kernels, ProfilingSettings, rng,
                                      device),
              "device_trace": _device_trace(Simulator, observability, rng, device)}
    lap("speculation, timed windows, profiling")

    # --- the multi-device round loop, every shard on this card -------------
    split = _split_phase(kernels, fd_bench, engine, device)
    sharded = _sharded_decisions(Simulator, engine, shard, kernels, rng, device)
    lap("split and sharded")

    # --- the mesh over several processes, and the port's own fault plane --
    multihost = multihost_phase(Simulator, shard, kernels, card)
    lap("multihost")
    replay = fault_replay_phase(kernels, jitwatch, device, card)
    lap("fault replay")

    # --- the driver's host planes, after every timed window above --------
    planes_result, view_change = planes_path(device, card)
    _, parent_topr = finish_topr_builds(topr_builds, card)
    topr = topr_phase(device, card, view_change, parent_topr)
    del view_change
    planes_result["host_memory"] = planes_host_memory(device, card)
    from rapid_tpu_torch.cli import scenarios as port_scenarios

    golden_runs = planes_golden_runs(device, result=port_scenarios.zone_churn_result)
    golden_misses = planes_golden_check(device, golden_runs)
    assert not any(golden_misses.values()), f"planes: runs differ from {PLANES_GOLDEN}: " + "; ".join(
        m for misses in golden_misses.values() for m in misses[:5])
    print(f"planes, golden: the bench's serving dimension, the sweep's {SWEEP_N}-member placement "
          f"point and hierarchy-zone-churn equal tests/golden/torch_planes.json exactly ({card})",
          flush=True)
    zone_churn = {"record": golden_runs["zone_churn"]["scenario"],
                  "launches": golden_runs["zone_churn"]["launches"]}
    del golden_runs
    lap("planes")

    # --- the scenario battery and the paper's experiments, after the planes:
    # hierarchy-zone-churn is the planes phase's run ---------------------------
    scenario_result = scenarios_phase(card, kernels, zone_churn, message_load_child)
    lap("scenarios")
    # --- the tools and examples: Fig. 13's load balancer and the swarm agent
    # with their swarms on the card, perfscope and tracecat on the card's own
    # artifacts ----------------------------------------------------------------
    tools_result = tools_examples_phase(card, kernels)
    lap("tools and examples")
    # --- the last experiment: the warmed decision across the scale axis ----
    sweep_result = scaling_sweep_phase(card, kernels)
    lap("scaling sweep")
    # (scenario or experiment, launches) of each run of the phase that launched the kernel
    scenario_launches = {}
    runs_launches = [(name, run["launches"]) for name, run in scenario_result["runs"].items()]
    runs_launches += [("join_wave 100k", scenario_result["join_wave"]["launches"]),
                      ("fig11_conflict_sweep", scenario_result["fig11_launches"])]
    for label, launches in runs_launches:
        for name, count in launches.items():
            scenario_launches.setdefault(name, []).append((label, count))

    # each kernel's launches are those of its own path's run: the scan path
    # (ingress loss 1.0) under the policy the kernel serves
    path_launches = dict(scan_launches)
    path_launches["fd_phase_fused_windowed"] = (
        windowed["ingress_loss"]["launches"]["fd_phase_fused_windowed"])
    line = {"kernels": []}
    for name, sizes in kernel_results.items():
        main_shape = sizes[f"{KERNEL_SIZES[0]}x10"]
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "rapid_tpu_torch/csrc/" + (
                "fd_phase_fused.cu" if name.startswith("fd_phase_fused") else "fd_phase.cu"),
            "replaces": "rapid_tpu/sim/pallas_kernels.py:54",
            "on_main_path": name == "fd_phase_fused",
            "path": ("windowed scan (ingress loss 1.0)" if name == "fd_phase_fused_windowed"
                     else "scan (ingress loss 1.0)"),
            "launches": path_launches[name],
            "launches_headline": headline_launches[name],
            # (bridged pump, launches) of each pump of the bridge phase that ran it
            "launches_bridged": bridged_launches.get(name, []),
            # (gateway step, launches) of each decision pump of the gateway phase that ran it
            "launches_gateway": gateway_launches.get(name, []),
            # (pump, launches) of the real port members' bridged pumps, and
            # (step, launches) of the port agent's decision pumps
            "launches_member": member_launches.get(name, []),
            "launches_agent": agent_launches.get(name, []),
            # the live planes' phase (serving, hierarchy, recovery): no kernel
            "launches_live_planes": live["launches"].get(name, 0),
            # (run, launches) of the search (sim harness): the capacity-5 hunt, the 100k probe
            "launches_search": search_launches.get(name, []),
            # the 100k fault replay (drop rule at 1.0 and the gray streak: the scan path)
            "launches_replay": replay["launches"].get(name, 0),
            # (scenario or experiment, launches) of the scenarios phase's runs
            "launches_scenarios": scenario_launches.get(name, []),
            "match": True,
            "max_abs_err": max(s["max_abs_err"] for s in sizes.values()),
            "ms": main_shape["ms"],
            "kernel_ms": main_shape["ms"],
            "hot_ms": main_shape.get("hot_ms", main_shape["ms"]),
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_us": main_shape["bound_us"],
            "bound_by": main_shape["bound_by"],
            "tolerance": 0,
            "library_ms": None,  # no single PyTorch call computes this fused phase
            "sizes": sizes,
        })
    # the split's kernels: launches from the sharded decisions (8 shards; the
    # windowed instantiation from the windowed one on 4 shards)
    split_launches = {
        "fd_phase_rows": sharded["8 shards"]["launches"]["fd_phase_rows"],
        "fd_phase_rows_windowed":
            sharded["windowed 4 shards"]["launches"]["fd_phase_rows_windowed"],
        "fd_gather": sharded["8 shards"]["launches"]["fd_gather"],
    }
    for name, t in split.items():
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "rapid_tpu_torch/csrc/fd_phase_fused.cu",
            "replaces": "rapid_tpu/sim/pallas_kernels.py:54",
            "on_main_path": True,
            "path": ("sharded decision, windowed, 4 shards" if name.endswith("windowed")
                     else "sharded decision, 8 shards"),
            "launches": split_launches[name],
            "launches_bridged": bridged_launches.get(name, []),
            "launches_gateway": gateway_launches.get(name, []),
            "launches_member": member_launches.get(name, []),
            "launches_agent": agent_launches.get(name, []),
            # the live planes' phase (serving, hierarchy, recovery): no kernel
            "launches_live_planes": live["launches"].get(name, 0),
            "launches_search": search_launches.get(name, []),
            "launches_scenarios": scenario_launches.get(name, []),
            # (run, rank, launches) of each process of the multi-process decisions
            "launches_multiprocess": [
                (label, r["process"], r["launches"].get(name, 0))
                for label, run in multihost.items() for r in run["ranks"]],
            "match": True,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "kernel_ms": t["ms"],
            "hot_ms": t.get("hot_ms", t["ms"]),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_us": t["bound_ms"] * 1e3,
            "bound_by": t["bound_by"],
            "tolerance": 0,
            # no single PyTorch call computes either half; fd_gather's gather
            # alone, torch.gather on the unpacked [C, K] bits, is timed beside it
            "library_ms": None,
            "gather_only_ms": t.get("gather_only_ms"),
            "sizes": {f"{t['shape'][0]}x10": t},
        })
    # the FD kernels split the key and draw: no round path launches the draw
    # block, neither lossy nor on a mesh
    draw_launches = dict(
        launches=scan_launches["threefry_draw"],
        launches_windowed=windowed["ingress_loss"]["launches"]["threefry_draw"],
        launches_sharded=sharded["8 shards"]["launches"]["threefry_draw"],
        launches_bridged=bridged_launches.get("threefry_draw", []),
        launches_gateway=gateway_launches.get("threefry_draw", []),
        launches_member=member_launches.get("threefry_draw", []),
        launches_agent=agent_launches.get("threefry_draw", []),
        launches_search=search_launches.get("threefry_draw", []),
        launches_replay=replay["launches"].get("threefry_draw", 0),
        launches_scenarios=scenario_launches.get("threefry_draw", []),
        launches_multiprocess=[(label, r["process"], r["launches"].get("threefry_draw", 0))
                               for label, run in multihost.items() for r in run["ranks"]],
    )
    counts = [v for v in draw_launches.values() if isinstance(v, int)] + [
        row[-1] for v in draw_launches.values() if isinstance(v, list) for row in v]
    assert not any(counts), f"threefry_draw launched on a round path: {draw_launches}"
    line["kernels"].append(dict(threefry_line, **draw_launches))
    main_case = topr[TOPR_CASES[0][0]]
    line["kernels"].append({
        "name": "placement_topr",
        "route": "cuda",
        "source": "rapid_tpu_torch/csrc/placement_topr.cu",
        # no Pallas kernel: the XLA program of build_jit, and numpy topr_full
        "replaces": "rapid_tpu/placement/device.py:194",
        "on_main_path": True,
        "path": "planes, full width (enable_placement and the crash's view change)",
        "launches": planes_result["launches"]["placement_topr"],
        "launches_live_planes": live["launches"].get("placement_topr", 0),
        "launches_search": search_launches.get("placement_topr", []),
        "launches_scenarios": scenario_launches.get("placement_topr", []),
        # (enable_placement, the view change) at the scaling sweep's placement point
        "launches_sweep": sweep_result["placement_point"]["placement_topr"],
        "match": True,
        "max_abs_err": max(t["max_abs_err"] for t in topr.values()),
        "ms": main_case["ms"],
        "kernel_ms": main_case["ms"],
        "hot_ms": main_case["hot_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_us": main_case["bound_ms"] * 1e3,
        "bound_by": main_case["bound_by"],
        "tolerance": 0,
        "library_ms": None,  # no single PyTorch call computes a rendezvous top-R
        "sizes": topr,
    })
    print(json.dumps(line))
    print(json.dumps({"headline_wall_ms": head_walls, "scan_wall_ms": scan_walls,
                      "headline_syncs": syncs, "scan_syncs": scan_syncs,
                      "windowed": windowed, "classic_fallback": fallback,
                      "sharded": sharded, "driver_planes": planes, "card": card,
                      "multihost": multihost, "fault_replay": replay,
                      "bridge": dict(bridge, pumps=[dict(p, cut=len(p["cut"]))
                                                    for p in bridge["pumps"]]),
                      "wire": wire, "gateway": gateway, "planes": planes_result,
                      "members": {"pumps": [dict(p, cut=len(p["cut"])) for p in members["pumps"]]},
                      "agent": agent, "live_planes": live, "search": search,
                      "native": native, "grpc": grpc_result, "scenarios": scenario_result,
                      "tools_examples": tools_result, "scaling_sweep": sweep_result},
                     default=str))
    phases["total"] = round(time.perf_counter() - started, 1)
    print(f"phase seconds ({card}): {json.dumps(phases)}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def agent_loop(iterations: int, members_every: int = 1, n: int = N_NODES, device=None) -> int:
    """``python3 chip_smoke.py --agent-loop N [M]``: ``member_sequence`` then
    ``agent_sequence`` at ``n`` (100k) on the card, in one process, N times
    or until the agent's status disagrees with the gateway; the member
    phase runs in every ``M``-th iteration only, from the first (``device``:
    run there instead). A disagreement prints ``agent_sequence``'s dump
    (``_agent_fork_dump``: both ids, the agent's journal and VIEW_CHANGE
    lines, the bridge's repair paths) and returns 1. The member phase comes
    first as in the script: the agent phase first in a fresh process fails
    its sync audit (the debug mode misses two ``sim.ready`` syncs)."""
    if device is None:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
                  file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from rapid_tpu_torch.sim import kernels

        kernels.build()
        device = torch.device("cuda", torch.cuda.current_device())
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
        ).stdout.strip().splitlines()[0]
    else:
        card = str(device)
    print(f"card: {card}", flush=True)
    os.environ["RAPID_JITWATCH"] = "1"
    started = time.perf_counter()
    for i in range(iterations):
        t0 = time.perf_counter()
        if i % members_every == 0:
            member_sequence(n, device)
        t1 = time.perf_counter()
        try:
            agent = agent_sequence(n, device)
        except AssertionError as exc:
            print(f"agent loop, iteration {i + 1}: the agent's status disagrees with the gateway "
                  f"({card}): {exc}", flush=True)
            print(json.dumps({"iterations": i + 1, "mismatches": 1, "card": card}))
            return 1
        print(f"agent loop, iteration {i + 1} of {iterations} ({card}): every step's id equal: "
              + "; ".join(f"{row['name']} {row['configuration_id']}" for row in agent["steps"])
              + (f"; member phase {t1 - t0:.1f} s" if i % members_every == 0 else "")
              + f"; agent phase {time.perf_counter() - t1:.1f} s", flush=True)
    print(json.dumps({"iterations": iterations, "mismatches": 0, "card": card,
                      "seconds": round(time.perf_counter() - started, 1)}))
    return 0


def view_race(trials: int, n: int = N_NODES, seed: int = SEED) -> int:
    """``python3 chip_smoke.py --view-race TRIALS [N]``: the agent's race on
    its own, unforced, on this host's CPU (no card). A ``MembershipView`` of
    ``n`` synthesized members; each trial deletes 1% of them, as a crash's
    view change does on the protocol thread, while a second thread (the
    agent's status tick, ``cli/agent.py``) reads the configuration id once,
    at a random point in the last 40% of the delete loop or just after it.
    A fork is a trial after which the view's id is not the fold of its
    content. The deleted members come back with fresh identifiers between
    trials. Prints the forks and returns 1 if there was one."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapid_tpu_torch import hashing
    from rapid_tpu_torch.membership import MembershipView
    from rapid_tpu_torch.sim.topology import VirtualCluster
    from rapid_tpu_torch.types import Endpoint, NodeId

    vc = VirtualCluster.synthesize(n, NATIVE_K, seed)
    endpoints = [Endpoint(bytes(vc.hostnames[i, :vc.host_lengths[i]]), int(vc.ports[i]))
                 for i in range(n)]
    view = MembershipView(NATIVE_K, [NodeId(int(h), int(lo)) for h, lo in
                                     zip(vc.id_high, vc.id_low)], endpoints)
    rng = random.Random(seed)

    def content_id():
        return hashing.configuration_id(
            ((i.high, i.low) for i in view._identifiers),  # noqa: SLF001
            ((ep.hostname, ep.port) for ep in view.get_ring(0)))

    forks, loop_s = [], None
    for trial in range(trials + 1):
        view.get_current_configuration_id()
        victims = rng.sample(endpoints, n // 100)
        delay = None if loop_s is None else rng.uniform(0.6, 1.05) * loop_s
        reader = None
        if delay is not None:
            def tick(delay=delay):
                time.sleep(delay)
                view.get_current_configuration_id()
            reader = threading.Thread(target=tick)
            reader.start()
        t0 = time.perf_counter()
        for ep in victims:
            view.ring_delete(ep)
        if loop_s is None:
            loop_s = time.perf_counter() - t0  # the first trial times the loop, unraced
        installed = view.get_current_configuration_id()
        if reader is not None:
            reader.join()
        cached, content = view.get_current_configuration_id(), content_id()
        if installed != content or cached != content:
            forks.append({"trial": trial, "tick_at": round(delay / loop_s, 3),
                          "installed_is_content": installed == content})
        for ep in victims:
            view.ring_add(ep, NodeId(rng.getrandbits(63), rng.getrandbits(63)))
    print(f"view race, {n} members, 1% deleted a trial, {trials} trials (the delete loop "
          f"{loop_s * 1e3:.1f} ms): {len(forks)} forks {forks}", flush=True)
    return 1 if forks else 0


def grpc_loop(trials: int, busy: int = 1, agree_s: float = 20.0) -> int:
    """``python3 chip_smoke.py --grpc-loop TRIALS [BUSY]``: ``grpc_cluster``
    (a seed, 20 concurrent joiners, a crash) TRIALS times in one process on
    this host's CPU (no card), with BUSY threads of pure-Python work beside
    it that take the interpreter lock as a simulator's pump does, each
    agreement within ``agree_s`` s. Prints each trial's walls or failure
    (a join that failed, or members at different sizes after the crash) and
    a JSON line of the counts; returns 1 if a trial failed."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    stop = threading.Event()

    def spin():
        x = 0
        while not stop.is_set():
            for i in range(20_000):
                x += i * i
            time.sleep(0.001)

    spinners = [threading.Thread(target=spin, name=f"grpc-loop-busy-{i}", daemon=True)
                for i in range(busy)]
    for t in spinners:
        t.start()
    counts = {"ok": 0, "join failed": 0, "crash not agreed": 0}
    try:
        for trial in range(trials):
            t0 = time.perf_counter()
            try:
                grpc_cluster("cpu", agree_s=agree_s)
                counts["ok"] += 1
            except AssertionError as exc:
                kind = "join failed" if "Exception(" in str(exc) else "crash not agreed"
                counts[kind] += 1
                print(f"grpc loop, trial {trial + 1}: {kind}: {str(exc)[:300]}", flush=True)
            print(f"grpc loop, trial {trial + 1} of {trials}, {busy} busy threads: "
                  f"{time.perf_counter() - t0:.1f} s {counts}", flush=True)
    finally:
        stop.set()
        for t in spinners:
            t.join()
    print(json.dumps({"trials": trials, "busy": busy, **counts}))
    return 0 if counts["ok"] == trials else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--gateway-member":
        sys.exit(gateway_member(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--view-race":
        sys.exit(view_race(*(int(a) for a in sys.argv[2:])))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--agent-loop":
        sys.exit(agent_loop(*(int(a) for a in sys.argv[2:])))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--grpc-loop":
        sys.exit(grpc_loop(*(int(a) for a in sys.argv[2:])))
    sys.exit(main())
