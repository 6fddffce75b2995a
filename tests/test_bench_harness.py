"""The bench runner: group registry, argument handling, the device fields
on every line, and refusal on any backend but a GPU (the tests run on the
CPU, so the refusal path is the real one here)."""
import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")
GPU = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
       "device_count": 1}


def _lines(out):
    return [json.loads(line) for line in out.strip().splitlines() if line]


def test_group_names_unique():
    names = [g[0] for g in bench.GROUPS]
    assert len(names) == len(set(names))


def test_groups_registry_metrics_unique():
    owned = [m for _, _, ms in bench.GROUPS for m in ms]
    assert len(owned) == len(set(owned))
    assert all(callable(fn) for _, fn, _ in bench.GROUPS)


def test_groups_cover_reference_chains():
    owned = {m for _, _, ms in bench.GROUPS for m in ms}
    for m in ("fm_demod_chain_throughput", "psk31_roundtrip_throughput",
              "ft8_batched_receive_throughput",
              "cofdm_frame_decode_throughput",
              "cofdm_frame_decode_throughput_sms",
              "dvb_t_decode_chain_throughput", "cofdm_frame_mod_throughput"):
        assert m in owned, m


def test_unknown_group_exits_nonzero():
    with pytest.raises(SystemExit) as e:
        bench.main(["--only", "definitely_not_a_group"])
    assert e.value.code != 0


def test_missing_group_name_exits_nonzero():
    with pytest.raises(SystemExit) as e:
        bench.main(["--only"])
    assert e.value.code != 0


def test_device_fields_refuse_cpu():
    with pytest.raises(SystemExit) as e:
        bench.device_fields()
    assert "GPU" in str(e.value) and "cpu" in str(e.value)


def test_refuses_off_gpu_and_prints_no_result():
    r = subprocess.run([sys.executable, BENCH, "--only", "fm"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "GPU" in r.stderr


def test_emit_names_device(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_DEVICE", dict(GPU))
    bench._emit("x_throughput", 12.5, "Msps", 5.0)
    rec, = _lines(capsys.readouterr().out)
    assert rec["metric"] == "x_throughput" and rec["value"] == 12.5
    assert rec["vs_baseline"] == 2.5
    for k, v in GPU.items():
        assert rec[k] == v


def test_emit_family_line_has_no_baseline(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_DEVICE", dict(GPU))
    bench._emit("fam_throughput", 3.0, "Msps")
    rec, = _lines(capsys.readouterr().out)
    assert "vs_baseline" not in rec and rec["platform"] == "gpu"


def test_run_groups_in_order(capsys, monkeypatch):
    monkeypatch.setattr(bench, "_DEVICE", dict(GPU))
    groups = [(f"g{i}", (lambda i=i: bench._emit(f"m{i}", i, "Msps")),
               [f"m{i}"]) for i in range(3)]
    assert bench.run_groups(groups)
    assert [r["metric"] for r in _lines(capsys.readouterr().out)] == \
        ["m0", "m1", "m2"]


def test_run_groups_reports_failure_and_continues(capsys, monkeypatch):
    monkeypatch.setattr(bench, "_DEVICE", dict(GPU))

    def boom():
        raise ValueError("deterministic bug")

    groups = [("bad", boom, ["bad_m", "bad_n"]),
              ("ok", lambda: bench._emit("good_m", 1.0, "Msps"), ["good_m"])]
    assert not bench.run_groups(groups)
    recs = {r["metric"]: r for r in _lines(capsys.readouterr().out)}
    assert "deterministic bug" in recs["bad_m"]["error"]
    assert "error" in recs["bad_n"] and recs["bad_n"]["platform"] == "gpu"
    assert recs["good_m"]["value"] == 1.0


def test_main_runs_only_the_selected_group(monkeypatch, capsys):
    import orion_sdr_tpu.runtime as runtime
    ran = []
    monkeypatch.setattr(bench, "device_fields", lambda: dict(GPU))
    monkeypatch.setattr(bench, "_DEVICE", {})
    monkeypatch.setattr(runtime, "use_compile_cache", lambda: "")
    monkeypatch.setattr(bench, "GROUPS", [
        ("fm", lambda: ran.append("fm"), ["a"]),
        ("dvb_t", lambda: (ran.append("dvb_t"),
                           bench._emit("b", 2.0, "Msps")), ["b"])])
    bench.main(["--only", "dvb_t"])
    assert ran == ["dvb_t"]
    rec, = _lines(capsys.readouterr().out)
    assert rec["device_kind"] == GPU["device_kind"]


def test_main_exits_nonzero_when_a_group_fails(monkeypatch):
    import orion_sdr_tpu.runtime as runtime
    monkeypatch.setattr(bench, "device_fields", lambda: dict(GPU))
    monkeypatch.setattr(bench, "_DEVICE", {})
    monkeypatch.setattr(runtime, "use_compile_cache", lambda: "")
    monkeypatch.setattr(bench, "GROUPS", [("fm", lambda: 1 / 0, ["a"])])
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 1
