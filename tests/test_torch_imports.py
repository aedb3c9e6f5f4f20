"""Import hygiene of the PyTorch port: it never imports JAX or the JAX
package, and it passes the project's invariant lint."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                            "sweep_splits.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_serve_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.launch.serve, repro_torch.convert\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
            "import repro_torch.launch.elastic_moe, repro_torch.launch.steps\n"
            "import repro_torch.launch.train, repro_torch.core.supernet\n"
            "import repro_torch.models.dit, repro_torch.models.unet\n"
            "import repro_torch.models.diffusion, repro_torch.launch.flops\n"
            "import repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.optim, repro_torch.distributed.fault\n"
            "import repro_torch.traffic, repro_torch.obs.export\n"
            "import repro_torch.runtime.arbiter, repro_torch.runtime.telemetry\n"
            "import repro_torch.cluster, repro_torch.chaos.live\n"
            "import repro_torch.obs.health, repro_torch.obs.stream, "
            "repro_torch.obs.profile\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_passes_invariant_lint():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro.analysis", "--lint",
                          "--root", PORT], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 findings" in res.stdout


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """Without a CUDA card (this host), and alone in a directory, the on-card
    smoke run exits non-zero and prints no result line."""
    import shutil
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120, env=env, cwd=cwd)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
