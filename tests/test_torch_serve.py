"""The PyTorch port's serve launcher, driven end to end on the CPU at the
smoke size (the kernels' plain versions), and its device rules."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(2)


def test_serve_smoke_prints_governors_and_zero_cold(capsys):
    serve.main(["--smoke", "--device", "cpu", "--requests", "8",
                "--trace-steps", "20"])
    out = capsys.readouterr().out
    assert "serving dynamic-ofa-smoke on cpu" in out
    assert "profiled 125 operating points over 25 subnets" in out
    for name in ("joint (paper)", "performance", "schedutil",
                 "static-pruned"):
        assert f"  {name}" in out
    assert "served 8 requests" in out
    assert "cold compiles while serving: 0" in out


def test_build_server_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = get_arch("dynamic-ofa-supernet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_server(arch, arch.make_smoke())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])     # --device cuda default


def test_build_server_resident_weights_in_compute_dtype():
    arch = get_arch("dynamic-ofa-supernet")
    cfg = arch.make_config()
    import dataclasses
    small = dataclasses.replace(cfg, n_layers=1)      # depth cut for speed
    server = serve.build_server(arch, small, device="cpu")
    w = server.params["layers"][0]["mlp"]["wi"]["kernel"]
    assert w.dtype == torch.bfloat16 and w.shape == (384, 1536)
    assert server.device == torch.device("cpu")


@pytest.mark.parametrize("flag", ["--nodes 2", "--router p2c",
                                  "--health-interval 1",
                                  "--rebalance-interval 1",
                                  "--stream-trace x", "--alerts-out x",
                                  "--profile-out x"])
def test_later_slice_flags_refused(flag, capsys):
    """The cluster, chaos and watchtower flags (once refused, now ported)
    parse to the reference launcher's types."""
    name, value = flag.split()
    args = serve.parse_args(["--smoke", name, value])
    got = getattr(args, name[2:].replace("-", "_"))
    want = {"--nodes": 2, "--router": "p2c", "--health-interval": 1.0,
            "--rebalance-interval": 1.0}.get(name, value)
    assert got == want and type(got) is type(want)
    assert capsys.readouterr().err == ""


def test_serve_specs_match_reference_launcher():
    from repro.configs import dynamic_ofa_supernet as j_ofa
    cfg = get_arch("dynamic-ofa-supernet").make_config()
    jcfg = j_ofa.make_config()
    want = list(dict.fromkeys(
        [jcfg.elastic.max_spec(), jcfg.elastic.min_spec()]
        + list(jcfg.elastic.enumerate(limit=24))))
    assert [s.name() for s in serve.serve_specs(cfg)] == \
        [s.name() for s in want]


def test_trace_mode_end_to_end_then_replay(tmp_path, capsys):
    """--trace poisson with every output at the smoke size on the CPU, then
    the recorded schedule fed back through --trace <file>."""
    import json

    from repro_torch.obs import iter_trace_events
    from repro_torch.runtime import CalibrationStore
    p = {k: str(tmp_path / n) for k, n in (
        ("cal", "cal.json"), ("trace", "t.json"), ("prom", "m.prom"),
        ("rec", "rec.json"), ("json", "m.json"))}
    base = ["--smoke", "--device", "cpu", "--trace-duration", "1",
            "--requests", "8", "--trace-steps", "5"]
    serve.main(base + ["--trace", "poisson", "--calibrate",
                       "--calibrate-out", p["cal"], "--trace-out",
                       p["trace"], "--metrics-out", p["prom"],
                       "--record", p["rec"]])
    out = capsys.readouterr().out
    assert "trace mode [poisson]" in out
    for line in ("  interactive  {", "  batch        {", "  arbiter      {",
                 "p50:", "p95:", "calibration store saved"):
        assert line in out
    events = list(iter_trace_events(p["trace"]))
    assert any(e.get("name") == "device" for e in events)
    prom = open(p["prom"]).read()
    assert 'engine_served_total{node="",tenant="interactive"}' in prom
    assert CalibrationStore.load(p["cal"]).summary()["latency"]
    rec = json.load(open(p["rec"]))
    assert set(rec["streams"]) == {"interactive", "batch"}
    n_rec = {k: len(v) for k, v in rec["streams"].items()}
    serve.main(base + ["--trace", p["rec"], "--metrics-out", p["json"]])
    out = capsys.readouterr().out
    assert f"[{p['rec']}] {n_rec['interactive']} interactive + " \
        f"{n_rec['batch']} batch arrivals" in out
    snap = json.loads(open(p["json"]).read())
    served = {s["labels"]["tenant"]: s["value"] for s in snap["series"]
              if s["name"] == "engine_served_total"}
    assert served == {k: float(v) for k, v in n_rec.items()}


def test_serve_path_writes_trace_and_metrics(tmp_path, capsys):
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                "--trace-steps", "5", "--trace-out", t, "--metrics-out", m])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    assert "4 request trees retained" in out
    assert "default (n=4):" in out
    assert "engine_served_total" in open(m).read()
