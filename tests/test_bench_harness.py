"""bench.py harness robustness: the artifact must survive a section that
hangs, and the searches must publish the right operating points.
CPU-only tests of the pure harness pieces — no device is touched."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench


def test_bounded_section_returns_result():
    out, hung = bench._bounded_section("t", lambda: {"x": 1}, 5.0, {"e": 1})
    assert out == {"x": 1} and not hung


def test_bounded_section_watchdog_fires_and_keeps_fallback():
    t0 = time.monotonic()
    out, hung = bench._bounded_section(
        "t", lambda: time.sleep(60), 0.3, {"error": "hung", "passes": False})
    assert hung and out == {"error": "hung", "passes": False}
    # the watchdog must not wait for the hung section
    assert time.monotonic() - t0 < 5.0


def test_bounded_section_exception_inside_section():
    def boom():
        raise RuntimeError("section blew up")
    # an exception in the section thread must not propagate or hang the
    # join; the fallback is returned (box never populated)
    out, hung = bench._bounded_section("t", boom, 5.0, {"e": "fb"})
    assert not hung and out == {"e": "fb"}


def test_compact_line_handles_missing_sections():
    """The hard-deadline path prints a compact line from a PARTIAL result
    (later sections may be absent entirely)."""
    import json
    line = bench._compact_line({"metric": "m", "value": 0})
    d = json.loads(line)
    assert d["latency_curve_legs"] == {} and d["mixed_fleet_counts"] == {}
    line = bench._compact_line({
        "metric": "m", "value": 7,
        "latency_curve": [{"added_latency_ms": 150.0, "legs": 256}],
        "mixed_fleet": {"passes": True, "video": {"streams": 4}}})
    d = json.loads(line)
    assert d["latency_curve_legs"] == {"150ms": 256}
    assert d["mixed_fleet_counts"] == {"video": 4}


def test_hard_deadline_writes_partial_artifact(tmp_path, monkeypatch):
    """A wedged main thread past the deadline still produces BENCH.json
    with the rows measured so far. os._exit is stubbed: the timer thread
    must have completed the write+prints before calling it."""
    import json
    import threading
    bench_file = tmp_path / "BENCH.json"
    monkeypatch.setattr(bench, "_bench_path", lambda: str(bench_file))
    exited = threading.Event()
    monkeypatch.setattr(bench.os, "_exit", lambda code: exited.set())
    result = {"metric": "m", "value": 0, "partial": True}
    t = bench._arm_hard_deadline(result, 0.2)
    result["value"] = 1234              # a section completed meanwhile
    assert exited.wait(5.0)
    d = json.loads(bench_file.read_text())
    assert d["value"] == 1234 and "hard deadline" in d["error"]
    t.cancel()


def test_hard_deadline_cancel_before_fire(tmp_path, monkeypatch):
    bench_file = tmp_path / "BENCH.json"
    monkeypatch.setattr(bench, "_bench_path", lambda: str(bench_file))
    t = bench._arm_hard_deadline({"metric": "m", "value": 0}, 30.0)
    t.cancel()
    time.sleep(0.1)
    assert not bench_file.exists()


def test_main_wiring_incremental_artifact(tmp_path, monkeypatch, capsys):
    """main() with every section stubbed: the artifact must checkpoint
    incrementally, end complete (no 'partial' key), and print the full +
    compact JSON lines."""
    import json
    import types
    bench_file = tmp_path / "BENCH.json"
    monkeypatch.setattr(bench, "_bench_path", lambda: str(bench_file))

    res = types.SimpleNamespace(ms_per_tick=9.1, loss_rate=0.0,
                                fidelity=0.99, mouth_to_ear_ms=1280.0,
                                auth_failures=0, late_ticks=0, ticks=768,
                                phases_ms={"edge": 1.2})
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(bench, "device_info", lambda: device)
    monkeypatch.setattr(bench, "device_only_legs", lambda: (4096, 8.0))
    monkeypatch.setattr(bench, "e2e_legs", lambda deadline=None: (1024, res))
    monkeypatch.setattr(
        bench, "srtp_e2e",
        lambda n, suite="AES_CM_128_HMAC_SHA1_80", deadline=None: (512, res))
    monkeypatch.setattr(bench, "latency_curve",
                        lambda n, deadline=None: [
                            {"K": 4, "D": 2, "added_latency_ms": 150.0,
                             "legs": 256, "ms_per_tick": 9.0}])
    monkeypatch.setattr(bench, "video_e2e",
                        lambda deadline=None: (4, types.SimpleNamespace(
                            fps_received_min=14.1), True))
    monkeypatch.setattr(bench, "mfu_summary", lambda: {"flagship_mfu": 0.1})
    monkeypatch.setattr(bench, "mixed_fleet",
                        lambda a, b, deadline=None: {"passes": True,
                                                     "flagship":
                                                     {"legs": 512}})
    monkeypatch.setattr(bench, "device_vs_cpu", lambda: {"pass": True})
    bench.main()

    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    # a compact checkpoint line after EVERY section (driver-kill safety),
    # then the full line, then the final compact line LAST
    assert len(lines) >= 4
    full = json.loads(lines[-2])
    compact = json.loads(lines[-1])
    # every checkpoint line must itself be parseable and carry the headline
    for ln in lines[:-2]:
        d = json.loads(ln)
        assert "value" in d and "mfu" not in d
    assert full["value"] == 1024 and "partial" not in full
    assert full["device_only_legs"] == 4096
    assert full["device"] == device and compact["device"] == device
    assert full["device_vs_cpu"] == {"pass": True}
    assert full["srtp_e2e_legs"] == 512 and full["srtp_gcm_e2e_legs"] == 512
    assert full["srtp_phases_ms"] == {"edge": 1.2}
    assert full["latency_curve"][0]["legs"] == 256
    assert full["video_e2e_streams"] == 4 and full["video_pli_recovery_ok"]
    assert full["mixed_fleet"]["passes"] is True
    assert set(full["section_s"]) >= {"device_only", "e2e", "srtp", "fleet",
                                      "latency", "video", "srtp_gcm", "mfu",
                                      "corr"}
    assert compact["latency_curve_legs"] == {"150ms": 256}
    assert compact["mixed_fleet_counts"] == {"flagship": 512}
    disk = json.loads(bench_file.read_text())
    assert disk == full


class _FakeVideoRes:
    def __init__(self, ok, fps_min=14.0):
        self._ok = ok
        self.ms_per_tick = 66.0
        self.late_ticks = 0
        self.fps_received_min = fps_min
        self.fps_nominal = 15.0

    def passes(self):
        return self._ok


def test_video_e2e_walks_down_to_a_nonzero_row(monkeypatch):
    """A failing first trial (n=4) must not zero the row: the search walks
    down to the largest passing N (the r4 snapshot artifact recorded
    video_e2e_streams=0 because the old search broke on first FAIL)."""
    import mediastreamer2_tpu.models.video_e2e_bench as veb
    tried = []

    class FakeBench:
        def __init__(self, factory, n, **kw):
            self.n = n
            tried.append(n)

        def run(self, **kw):
            # only n<=2 sustains nominal fps on this fake host; the fail
            # is decisive (fps far below nominal -> no transient retry)
            return _FakeVideoRes(self.n <= 2,
                                 fps_min=14.2 if self.n <= 2 else 3.0)

        def run_loss_recovery(self, **kw):
            return True

        def close(self):
            pass

    monkeypatch.setattr(veb, "VideoE2EBench", FakeBench)
    best, res, rec = bench.video_e2e()
    assert best == 2 and rec is True
    assert tried[:2] == [4, 2]          # walked down, then climbed back


def test_video_e2e_bisects_the_pass_fail_gap(monkeypatch):
    """After a pass at 8 and a decisive fail at 16 the walk bisects
    (12, then 14) instead of publishing the last power of two — the r5
    official run left 10-14 streams unexplored exactly this way."""
    import mediastreamer2_tpu.models.video_e2e_bench as veb
    tried = []

    class FakeBench:
        def __init__(self, factory, n, **kw):
            self.n = n
            tried.append(n)

        def run(self, **kw):
            return _FakeVideoRes(self.n <= 12,
                                 fps_min=14.2 if self.n <= 12 else 3.0)

        def run_loss_recovery(self, **kw):
            return True

        def close(self):
            pass

    monkeypatch.setattr(veb, "VideoE2EBench", FakeBench)
    best, res, rec = bench.video_e2e()
    assert best == 12
    assert tried == [4, 8, 16, 12, 14]


def test_video_e2e_transient_near_miss_retried_once(monkeypatch):
    """A near-miss (frames flowed, fps just short) is retried once at the
    same N before the search walks down — same policy as latency rows."""
    import mediastreamer2_tpu.models.video_e2e_bench as veb
    calls = {"n4": 0}

    class FakeBench:
        def __init__(self, factory, n, **kw):
            self.n = n

        def run(self, **kw):
            if self.n == 4:
                calls["n4"] += 1
                # first trial: near-miss (>=0.5x nominal); second: pass
                return _FakeVideoRes(calls["n4"] >= 2, fps_min=13.0)
            return _FakeVideoRes(False, fps_min=3.0)

        def run_loss_recovery(self, **kw):
            return True

        def close(self):
            pass

    monkeypatch.setattr(veb, "VideoE2EBench", FakeBench)
    best, res, rec = bench.video_e2e()
    assert best == 4 and calls["n4"] == 2


def test_mixed_fleet_search_brackets_edge_and_confirms(monkeypatch):
    """The fleet search shrinks on a fail, CONFIRMS a pass by re-running
    the same built fleet, grows toward the known-fail point, and publishes
    the confirmed passing operating point (never an oversized failure).

    cpu_count is pinned: the start size is host-core-dependent (1-core
    hosts start at the probe-validated floor) and this test exercises the
    multi-core start=512 bracket path regardless of the box it runs on."""
    import os as _os
    monkeypatch.setattr(_os, "cpu_count", lambda: 8)
    import mediastreamer2_tpu.models.mixed_fleet as mf
    built = []

    class FakeFleet:
        def __init__(self, factory_cls, n_flagship, n_srtp, n_opus,
                     n_video, **kw):
            self.sizes = dict(n_flagship=n_flagship, n_srtp=n_srtp,
                              n_opus=n_opus, n_video=n_video)
            built.append(dict(self.sizes))

        def run(self, seconds):
            ok = self.sizes["n_flagship"] <= 256
            fleet_self = self

            class R:
                def summary(self):
                    return {"passes": ok,
                            "flagship": {"legs":
                                         fleet_self.sizes["n_flagship"]}}
            return R()

        def close(self):
            pass

    monkeypatch.setattr(mf, "MixedFleetBench", FakeFleet)
    out = bench.mixed_fleet(n_flagship=2048, n_srtp=1024)
    assert out["passes"] is True
    assert out["confirmed"] is True          # pass re-ran on the same fleet
    assert out["flagship"]["legs"] == 256    # the edge point, not the fail
    assert len(out["attempts"]) >= 2
    # first attempt failed (512 on this fake host); every fail gets ONE
    # same-size retry (the walks' courtesy), then the shrink happened
    assert built[1]["n_flagship"] == built[0]["n_flagship"]
    assert built[2]["n_flagship"] < built[0]["n_flagship"]
    # after the pass the search probed BETWEEN the pass and the known fail
    assert built[0]["n_flagship"] > built[-1]["n_flagship"] > 256
    assert "host_cores" in out and out["mode"] in ("loop", "threads")


def test_mixed_fleet_grows_from_passing_floor(monkeypatch):
    """When the floor passes outright the search grows (doubling, capped by
    the homogeneous halves) instead of publishing the floor.  cpu_count
    pinned for a host-independent start size (see bracket test above)."""
    import os as _os
    monkeypatch.setattr(_os, "cpu_count", lambda: 8)
    import mediastreamer2_tpu.models.mixed_fleet as mf
    built = []

    class FakeFleet:
        def __init__(self, factory_cls, n_flagship, **kw):
            self.n = n_flagship
            built.append(n_flagship)

        def run(self, seconds):
            n = self.n

            class R:
                def summary(self):
                    return {"passes": True, "flagship": {"legs": n}}
            return R()

        def close(self):
            pass

    monkeypatch.setattr(mf, "MixedFleetBench", FakeFleet)
    out = bench.mixed_fleet(n_flagship=4096, n_srtp=2048)
    assert out["passes"] is True and out["confirmed"] is True
    assert built[0] == 512
    assert out["flagship"]["legs"] > 512     # grew past the floor


def test_mixed_fleet_bisects_after_doubling_fail(monkeypatch):
    """A pass followed by a doubling fail must BISECT the bracket (the
    r5 official run published 512 after a 1024 fail with 640-896 never
    probed — same upgrade as the video walk).  Fake edge at 799: expect
    512 pass -> 1024 fail (x2: one same-size retry per failing size) ->
    768 pass -> 896 fail (x2) -> publish 768."""
    import os as _os
    monkeypatch.setattr(_os, "cpu_count", lambda: 8)
    import mediastreamer2_tpu.models.mixed_fleet as mf
    built = []

    class FakeFleet:
        def __init__(self, factory_cls, n_flagship, **kw):
            self.n = n_flagship
            built.append(n_flagship)

        def run(self, seconds):
            n = self.n

            class R:
                def summary(self):
                    return {"passes": n <= 799, "flagship": {"legs": n}}
            return R()

        def close(self):
            pass

    monkeypatch.setattr(mf, "MixedFleetBench", FakeFleet)
    out = bench.mixed_fleet(n_flagship=4096, n_srtp=2048)
    assert out["passes"] is True and out["confirmed"] is True
    assert built == [512, 1024, 1024, 768, 896, 896]
    assert out["flagship"]["legs"] == 768


def test_mixed_fleet_floor_transient_fail_retries(monkeypatch):
    """A transient-looking fail AT THE FLOOR (fidelity/delivery held, only
    late ticks over bar — a host CFS stall cluster) retries instead of
    publishing the round's #1 row as a failure after a single attempt
    (r5c: opus 38 late from two ~45 ms stalls killed the row outright)."""
    import os as _os
    monkeypatch.setattr(_os, "cpu_count", lambda: 1)
    import mediastreamer2_tpu.models.mixed_fleet as mf
    runs = []

    class FakeFleet:
        def __init__(self, factory_cls, n_flagship, **kw):
            self.n = n_flagship

        def run(self, seconds):
            runs.append(self.n)
            ok = len(runs) > 1                 # first floor attempt fails
            n = self.n

            class R:
                def summary(self):
                    return {"passes": ok, "errors": None,
                            "flagship": {"legs": n, "fidelity": 1.0},
                            "srtp": {"legs": n // 2, "fidelity": 1.0},
                            "opus": {"legs": 8, "delivery": 1.0,
                                     "late_ticks": 38}}
            return R()

        def close(self):
            pass

    monkeypatch.setattr(mf, "MixedFleetBench", FakeFleet)
    out = bench.mixed_fleet(n_flagship=256, n_srtp=128)
    assert out["passes"] is True               # the retry rescued the row
    assert runs[0] == runs[1] == 128           # same floor size, retried


def test_mixed_fleet_growth_transient_fail_retries(monkeypatch):
    """A transient fail during GROWTH (r5d: 256/128 failed on one 60 ms
    CFS stall cluster and the search floor-clamped) gets one same-size
    retry; when the retry passes, the LARGER fleet is published."""
    import os as _os
    monkeypatch.setattr(_os, "cpu_count", lambda: 1)
    import mediastreamer2_tpu.models.mixed_fleet as mf
    runs = []

    class FakeFleet:
        def __init__(self, factory_cls, n_flagship, **kw):
            self.n = n_flagship

        def run(self, seconds):
            runs.append(self.n)
            # the FIRST attempt at 256 fails (stall cluster); its retry
            # and everything else up to 256 passes
            ok = self.n < 256 or runs.count(256) > 1
            n = self.n

            class R:
                def summary(self):
                    return {"passes": ok, "errors": None,
                            "flagship": {"legs": n, "fidelity": 1.0},
                            "srtp": {"legs": n // 2, "fidelity": 1.0},
                            "opus": {"legs": 8, "delivery": 1.0,
                                     "late_ticks": 22 if not ok else 0}}
            return R()

        def close(self):
            pass

    monkeypatch.setattr(mf, "MixedFleetBench", FakeFleet)
    out = bench.mixed_fleet(n_flagship=512, n_srtp=256)
    assert out["passes"] is True
    assert out["flagship"]["legs"] == 256    # retry rescued the growth step
    assert runs.count(256) >= 2              # the same size was retried


def test_mixed_fleet_structural_error_does_not_retry(monkeypatch):
    import mediastreamer2_tpu.models.mixed_fleet as mf
    built = []

    class FakeFleet:
        def __init__(self, factory_cls, **kw):
            built.append(1)
            raise RuntimeError("no such codec")

    monkeypatch.setattr(mf, "MixedFleetBench", FakeFleet)
    out = bench.mixed_fleet(n_flagship=1024, n_srtp=512)
    assert out["passes"] is False and "error" in out
    assert len(built) == 1              # errors are structural: no retry
