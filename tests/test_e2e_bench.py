"""E2E conference bench harness: real localhost UDP both ways per tick,
K-blocked device calls, fidelity oracle — small-N CPU validation of the
machinery bench.py runs at scale on the GPU."""
import pytest

from mediastreamer2_tpu.native import rtp_edge_available
from mediastreamer2_tpu.models.e2e_bench import E2EConferenceBench

pytestmark = pytest.mark.skipif(not rtp_edge_available(),
                                reason="g++ build failed")


def test_e2e_selfloop_traffic_and_fidelity(factory):
    b = E2EConferenceBench(factory, n_legs=16, k_block=4, pipeline_depth=1)
    try:
        res = b.run(n_blocks=30, paced=False, warmup_blocks=4)
        # self-loop traffic is sustained: jitter misses are rare once primed
        assert res.loss_rate < 0.05, res
        # transport fidelity: what probe legs sent == what they received
        assert res.fidelity > 0.9, res
        assert res.ticks == 26 * 4
        assert res.late_ticks >= 0
    finally:
        b.close()


def test_e2e_k1_low_latency_shape(factory):
    """K=1,D=4 — the 80 ms latency-ladder config (one tick per device
    block, 4 in flight).  Exercises per-tick dispatch + the dispatch-time
    D2H copy issuance (_gpu_block issue_copies) that makes the single
    reader worker bandwidth-bound instead of RTT-bound (bench.py
    LATENCY_LADDER row 2)."""
    b = E2EConferenceBench(factory, n_legs=8, k_block=1, pipeline_depth=4)
    try:
        res = b.run(n_blocks=40, paced=False)
        assert res.loss_rate < 0.05, res
        assert res.fidelity > 0.9, res
        assert res.k_block == 1 and res.pipeline_depth == 4
    finally:
        b.close()
