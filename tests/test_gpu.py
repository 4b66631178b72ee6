"""On-card checks: the flagship step and its spectral building blocks as
compiled for the GPU, against the CPU backend and numpy float64.  Skipped
without a GPU; `python -m pytest -m gpu` runs them on the card."""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_flagship_step_on_gpu_is_finite(gpu):
    import jax
    from mediastreamer2_tpu import Factory
    from mediastreamer2_tpu.models.flagship import (build_flagship,
                                                    example_inputs)
    cg, params = build_flagship(Factory(), batch=64)
    _, out, _ = jax.jit(cg.step)(cg.init_state(), params, example_inputs(64))
    assert out["out"].devices() == {gpu}
    y = np.asarray(out["out"])
    assert y.shape == (64, 160) and np.isfinite(y).all()


def test_spectral_ops_hold_f32_precision_on_gpu(gpu):
    """HIGHEST precision: ~1e-6 relative error; a TF32 matmul gives ~1e-3."""
    from mediastreamer2_tpu.models.device_check import spectral_errors
    errs = spectral_errors(gpu, batch=16)
    assert max(errs.values()) <= 1e-5, errs


def test_flagship_gpu_matches_cpu_quality_bar(gpu):
    from mediastreamer2_tpu.models.device_check import device_vs_cpu
    res = device_vs_cpu(gpu, batch=16, ticks=40, spectral_batch=8)
    assert res["pass"], res
