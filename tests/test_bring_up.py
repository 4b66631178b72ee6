"""The main path as it is compiled for the GPU, checked on the CPU: no Pallas
call anywhere in the flagship and served steps, every f32 product of the
spectral / resampling / filtering paths at HIGHEST precision (never TF32),
the compile-cache placement, the published-peak table, the device-vs-CPU
quality gate, and the native build's error reporting."""
import os
import sys

import numpy as np
import pytest
import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (scan, cond, jit) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _flagship_step():
    from mediastreamer2_tpu import Factory
    from mediastreamer2_tpu.models.flagship import (build_flagship,
                                                    example_inputs)
    cg, params = build_flagship(Factory(), batch=8)
    return cg.step, (cg.init_state(), params, example_inputs(8))


def _e2e_step():
    from mediastreamer2_tpu import Factory
    from mediastreamer2_tpu.models.e2e_bench import build_e2e_graph
    cg, params = build_e2e_graph(Factory(), 8)
    ext = {"rx": np.zeros((8, 80), np.float32),
           "mic": np.zeros((8, 480), np.float32)}
    return cg.step, (cg.init_state(), params, ext)


@pytest.mark.parametrize("build", [_flagship_step, _e2e_step],
                         ids=["flagship", "e2e"])
def test_no_pallas_call_in_main_path(build):
    fn, args = build()
    prims = {e.primitive.name for e in _eqns(jax.make_jaxpr(fn)(*args).jaxpr)}
    assert "dot_general" in prims
    assert not any("pallas" in p for p in prims), prims


def _rfft_case(name, n=320):
    from mediastreamer2_tpu.ops import rfft as R
    x = np.zeros((4, n), np.float32)
    f = np.zeros((4, n // 2 + 1), np.float32)
    return {"rfft": (lambda a: R.rfft(a, n), (x,)),
            "irfft": (lambda r, i: R.irfft(r, i, n), (f, f)),
            "rfft_tail": (lambda a: R.rfft_tail(a, n), (x[:, :n // 2],)),
            "irfft_tail": (lambda r, i: R.irfft_tail(r, i, n), (f, f)),
            "apply_constraint": (lambda r, i: R.apply_constraint(r, i, n),
                                 (f, f))}[name]


def _graph_case(kind, fmt_kw, **node_kw):
    from mediastreamer2_tpu import Factory, Format, GraphBuilder
    g = GraphBuilder(Factory(), batch=4)
    g.chain(g.add("ext_source", "in", fmt=Format(**fmt_kw)),
            g.add(kind, "n", **node_kw), g.add("ext_sink", "out"))
    cg = g.build()
    shape, dtype = cg.ext_inputs["in"]
    return cg.step, (cg.init_state(), cg.init_params(),
                     {"in": np.zeros(shape, dtype)})


PRECISION_CASES = {
    **{k: (lambda k=k: _rfft_case(k)) for k in (
        "rfft", "irfft", "rfft_tail", "irfft_tail", "apply_constraint")},
    "resample_48k_16k": lambda: _graph_case("resample", {"rate": 48000},
                                            out_rate=16000),
    "resample_8k_48k": lambda: _graph_case("resample", {"rate": 8000},
                                           out_rate=48000),
    "eq": lambda: _graph_case("equalizer", {"rate": 16000}),
    "echo_canceller": lambda: _flagship_step(),
}


@pytest.mark.parametrize("case", sorted(PRECISION_CASES))
def test_every_dot_general_runs_at_highest_precision(case):
    fn, args = PRECISION_CASES[case]()
    dots = [e for e in _eqns(jax.make_jaxpr(fn)(*args).jaxpr)
            if e.primitive.name == "dot_general"]
    assert dots, f"{case}: no dot_general traced"
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), (case, prec)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import mediastreamer2_tpu as ms
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert ms.compile_cache_dir() == str(tmp_path)
    assert ms.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import mediastreamer2_tpu as ms
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = ms.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _mfu():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import mfu
    return mfu


@pytest.mark.parametrize("kind,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 67e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 51e12, 2.0e12)),
])
def test_h100_peaks(kind, peaks):
    assert _mfu().chip_peaks(kind) == (kind, peaks)


def test_unknown_device_kind_has_no_default_peaks():
    with pytest.raises(KeyError, match="no published peaks"):
        _mfu().chip_peaks("cpu")


def _streams(seed=0, B=8, n=3200):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, n))).astype(np.float32)


def test_quality_gate_passes_identical_streams():
    from mediastreamer2_tpu.models.device_check import quality_gate
    ref = _streams()
    res = quality_gate(ref, ref.copy())
    assert res["pass"] and res["energy_gap_db_max"] == 0.0


def test_quality_gate_flags_2db_energy_gap():
    """Same waveform (audio_diff 1.0), 2 dB louder: the energy gate alone
    must fail it."""
    from mediastreamer2_tpu.models.device_check import quality_gate
    ref = _streams()
    got = ref * np.float32(10 ** (2.0 / 20))
    res = quality_gate(ref, got)
    assert res["audio_diff_min"] > 0.9999
    assert 1.9 < res["energy_gap_db_max"] < 2.1
    assert not res["pass"]


def test_quality_gate_exempts_only_groups_that_took_other_decisions():
    from mediastreamer2_tpu.models.device_check import quality_gate
    ref = _streams(B=16)
    got = ref.copy()
    got[5] += 0.15 * _streams(seed=9, B=16)[5]     # audio_diff ~0.99
    x_ref = np.zeros((16, 10), np.int8)
    x_got = x_ref.copy()
    assert not quality_gate(ref, got, x_ref, x_got)["pass"]
    x_got[6, 3] = 1                  # leg 6 promoted on another tick
    res = quality_gate(ref, got, x_ref, x_got)      # group 4..7 exempt
    assert res["pass"] and res["diverged_group_share"] == 0.25
    x_got[0, 3] = x_got[8, 3] = 1    # 3 of 4 groups diverged: too many
    assert not quality_gate(ref, got, x_ref, x_got)["pass"]


def test_aec_records_transfer_decisions():
    """The AEC's `xfer` record: int8 per leg, promote bit set once the
    shadow filter has converged on a pure echo."""
    from mediastreamer2_tpu.models.device_check import (flagship_inputs,
                                                        run_flagship)
    mic, far = flagship_inputs(4, 60)
    _, xfer = run_flagship(jax.devices("cpu")[0], mic, far)
    assert xfer.shape == (4, 60) and xfer.dtype == np.int8
    assert ((xfer & 1) != 0).any()


def test_native_build_surfaces_compiler_error(tmp_path):
    import shutil
    from mediastreamer2_tpu.native import NativeBuildError, _build_so
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    src = tmp_path / "bad.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(NativeBuildError, match="bad.cpp"):
        _build_so(str(src), str(tmp_path / "bad.so"))
    assert not (tmp_path / "bad.so").exists()


def test_gso_probe_is_consistent():
    from mediastreamer2_tpu.native import gso_supported
    assert gso_supported() in (True, False)
    assert gso_supported() is gso_supported()         # cached


def test_cleartext_main_path_imports_nothing_beyond_jax():
    """The served cleartext path (flagship graph + native edge) adds no
    third-party import to what JAX itself loads; `cryptography` stays
    lazy, for SRTP only."""
    import subprocess
    code = (
        "import sys, jax, jax.numpy as jnp\n"
        "jax.jit(lambda x: x + 1)(jnp.ones(3)).block_until_ready()\n"
        "base = {m.split('.')[0] for m in sys.modules}\n"
        "from mediastreamer2_tpu import Factory\n"
        "from mediastreamer2_tpu.models.e2e_bench import E2EConferenceBench\n"
        "b = E2EConferenceBench(Factory(), 8, k_block=1)\n"
        "b.run(8, paced=False)\n"
        "b.close()\n"
        "new = {m.split('.')[0] for m in sys.modules} - base\n"
        "print(sorted(t for t in new if t not in sys.stdlib_module_names\n"
        "             and not t.startswith('_')))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "['mediastreamer2_tpu']"
