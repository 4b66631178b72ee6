"""chip_smoke.py and the tools it leans on, at tiny sizes on the CPU: each
phase runs and gates, the script refuses to run without a GPU, the
sharded path holds on virtual devices, and the per-node trace reduction
attributes device time to graph nodes."""
import json
import os
import sys

import pytest
import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out.strip() == ""


def test_multi_refuses_without_gpu(capsys):
    assert chip_smoke.main(["--multi"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_flagship_tiny():
    res = chip_smoke.phase_flagship("cpu", legs=8, ticks=5, scan_ticks=3)
    assert res["device_ms_per_tick"] > 0
    assert res["memory_analysis"]["argument_size_in_bytes"] > 0


def test_phase_reference_tiny():
    res = chip_smoke.phase_reference("cpu", legs=8, ticks=8)
    assert res["pass"] and res["spectral_rel_err_max"] < 1e-5
    assert len(res["spectral_rel_err"]) == 23


def test_phase_served_tiny():
    res = chip_smoke.phase_served("cpu", legs=8, seconds=0.3)
    assert res["fidelity"] >= 0.9 and res["loss_rate"] < 0.02


def test_phase_multi_on_four_virtual_devices():
    assert len(jax.devices()) >= 4
    res = chip_smoke.phase_multi("cpu", n=4, legs=32)
    assert res["devices"] == 4 and res["edge"] in ("ok",
                                                   "native edge unavailable")
    assert res["sharded_vs_unsharded_max_abs"] <= 1e-4


def test_phase_multi_needs_enough_devices():
    with pytest.raises(RuntimeError, match="needs 64 GPUs"):
        chip_smoke.phase_multi("cpu", n=64, legs=256)


def test_trace_reduction_attributes_nodes(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_tick
    res = trace_tick.trace_flagship(legs=8, ticks=2, out_dir=str(tmp_path))
    assert {"ec", "agc", "rs"} <= set(res["node_ms_per_tick"])
    assert res["device_busy_ms_per_tick"] > 0 and 0 <= res["idle_share"] < 1
    json.dumps(res)


def test_hlo_op_nodes_maps_instruction_and_kernel_names():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_tick
    hlo = ('  %fusion.3 = f32[8]{0} fusion(%p), kind=kLoop, '
           'metadata={op_name="jit(run)/while/body/agc/mul"}\n'
           '  ROOT %dot.1 = f32[8]{0} dot(%a, %b), '
           'metadata={op_name="jit(run)/ec/dot_general"}\n'
           '  %add = f32[8]{0} add(%a, %b)\n')
    m = trace_tick.hlo_op_nodes(hlo, ["ec", "agc", "rs"])
    assert m == {"fusion.3": "agc", "fusion_3": "agc",
                 "dot.1": "ec", "dot_1": "ec"}


def test_bench_refuses_without_gpu():
    import bench
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        bench.device_info()


def test_measure_batch_oom_is_none_compile_error_raises(monkeypatch):
    import bench
    import mediastreamer2_tpu.models.flagship as fl

    def oom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating")
    monkeypatch.setattr(fl, "build_flagship", oom)
    assert bench.measure_batch(64) is None

    def broken(*a, **k):
        raise ValueError("INVALID_ARGUMENT: cannot lower")
    monkeypatch.setattr(fl, "build_flagship", broken)
    with pytest.raises(ValueError, match="cannot lower"):
        bench.measure_batch(64)
