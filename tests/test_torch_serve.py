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


@pytest.mark.parametrize("flag", ["--trace poisson", "--nodes 2",
                                  "--calibrate 1", "--trace-out x.json",
                                  "--metrics-out m.json"])
def test_later_slice_flags_refused(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--smoke"] + flag.split())
    assert e.value.code == 2
    assert "later slice of the port" in capsys.readouterr().err


def test_serve_specs_match_reference_launcher():
    from repro.configs import dynamic_ofa_supernet as j_ofa
    cfg = get_arch("dynamic-ofa-supernet").make_config()
    jcfg = j_ofa.make_config()
    want = list(dict.fromkeys(
        [jcfg.elastic.max_spec(), jcfg.elastic.min_spec()]
        + list(jcfg.elastic.enumerate(limit=24))))
    assert [s.name() for s in serve.serve_specs(cfg)] == \
        [s.name() for s in want]
