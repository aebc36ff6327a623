"""The port's reactor under the sanitizers, and its host C++ against the JAX
package's.

The twin of ``tests/test_native_tcp.py::test_reactor_tsan_stress_clean``:
``rapid_tpu_torch.native.run_stress`` builds ``csrc/host/rapid_io.cpp`` with
the stress harness (concurrent connects, echoing pollers, abrupt
disconnects, shutdown racing in-flight sends) under ThreadSanitizer and
under AddressSanitizer, with ``native/Makefile``'s flags, and runs it. A
sanitizer report or a failed assertion exits other than 0 and raises; the
test skips only where the toolchain cannot link the sanitizer at all.

The drift guard: each of the port's copies under
``rapid_tpu_torch/csrc/host/`` equals ``native/``'s once comments and blank
lines are stripped."""

from pathlib import Path

import pytest

from rapid_tpu_torch import native

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

REPO = Path(__file__).resolve().parents[1]
HOST_SOURCES = ("rapid_native.cpp", "rapid_io.cpp", "rapid_io_stress.cpp")


@pytest.mark.parametrize("sanitizer", native.SANITIZERS)
def test_reactor_stress_clean_under_sanitizer(sanitizer):
    missing = native.sanitizer_missing(sanitizer)
    if missing:
        pytest.skip(missing)
    exe, cmd = native.stress_path(sanitizer)
    assert f"-fsanitize={sanitizer}" in cmd and "-pthread" in cmd
    line, _ = native.run_stress(sanitizer)
    assert exe.exists()
    assert line.startswith("stress ok: frames_seen=")
    seen, echoes = (int(part.split("=")[1]) for part in line.split(": ")[1].split())
    # the lockstep half of the clients (4 of 8, 200 frames each) completes
    # its exchange: 800 frames each way at least (the harness asserts it)
    assert min(seen, echoes) >= 800


def test_stress_refuses_an_unknown_sanitizer():
    with pytest.raises(ValueError, match="not one of"):
        native.stress_path("memory")


def test_a_failed_stress_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    if native.sanitizer_missing("address"):
        pytest.skip(native.sanitizer_missing("address"))
    src, build = tmp_path / "src", tmp_path / "build"
    src.mkdir()
    (src / "rapid_io.cpp").write_text("int broken(")
    (src / "rapid_io_stress.cpp").write_text((native.HOST_SRC / "rapid_io_stress.cpp").read_text())
    monkeypatch.setattr(native, "HOST_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    with pytest.raises(RuntimeError, match="exited 1:\n.*rapid_io.cpp"):
        native.build_stress("address")
    assert list(build.iterdir()) == []  # no temporary left behind


def test_a_cxx_without_the_sanitizer_falls_back_to_the_path_g_plus_plus(monkeypatch):
    """``$CXX`` that cannot link the sanitizer (``false`` links nothing):
    the harness builds with the ``g++`` on the path where that one can; with
    no compiler that links it, the sanitizer is reported missing."""
    monkeypatch.setenv("CXX", "false")
    assert native._links(["false"], "thread").startswith("false cannot link -fsanitize=thread")
    cxx, why = native.stress_compiler("thread")
    if native._links(["g++"], "thread") is None:
        assert (cxx, why) == (["g++"], "") and native.sanitizer_missing("thread") is None
        assert native.stress_path("thread")[1][0] == "g++"
    else:
        assert cxx is None and native.sanitizer_missing("thread") == why
    monkeypatch.setattr(native, "_cxx", lambda: ["false"])
    monkeypatch.setitem(native._LINKS, ("g++", "thread"), "g++ cannot link it here")
    assert native.stress_compiler("thread") == (
        None, "false cannot link -fsanitize=thread: ; g++ cannot link it here")
    with pytest.raises(RuntimeError, match="g\\+\\+ cannot link it here"):
        native.stress_path("thread")


def strip_comments(text: str) -> list:
    """The C++ source's lines without ``//`` and ``/* */`` comments (string
    and character literals kept), trailing blanks or empty lines."""
    out, i, n = [], 0, len(text)
    quote = None
    while i < n:
        c = text[i]
        if quote:
            out.append(c)
            if c == "\\":
                out.append(text[i + 1])
                i += 1
            elif c == quote:
                quote = None
        elif c in "\"'":
            quote = c
            out.append(c)
        elif text.startswith("//", i):
            while i < n and text[i] != "\n":
                i += 1
            continue
        elif text.startswith("/*", i):
            end = text.index("*/", i + 2)
            out.append("\n" * text.count("\n", i, end))
            i = end + 2
            continue
        else:
            out.append(c)
        i += 1
    return [line.rstrip() for line in "".join(out).splitlines() if line.strip()]


def test_strip_comments_keeps_code_and_literals():
    src = 'int a = 1;  // one\n/* block\n spans */ int b = 2;\n\nconst char* s = "// kept";\n'
    assert strip_comments(src) == ["int a = 1;", " int b = 2;", 'const char* s = "// kept";']


@pytest.mark.parametrize("source", HOST_SOURCES)
def test_host_source_matches_the_jax_package_but_for_comments(source):
    port = (REPO / "rapid_tpu_torch" / "csrc" / "host" / source).read_text()
    jax = (REPO / "native" / source).read_text()
    assert strip_comments(port) == strip_comments(jax)
    assert len(strip_comments(jax)) > 50


def test_chip_smoke_stress_step_runs_both_sanitizers():
    """``chip_smoke.native_stress``, the step the card runs: a line each,
    build and run seconds and the harness's ``stress ok``."""
    import chip_smoke

    rows = chip_smoke.native_stress("cpu")
    assert set(rows) == set(native.SANITIZERS)
    for sanitizer, row in rows.items():
        if "absent" in row:
            assert native.sanitizer_missing(sanitizer), row
            continue
        assert row["line"].startswith("stress ok") and row["run_s"] > 0, (sanitizer, row)
