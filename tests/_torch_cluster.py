"""Shared setup of the cluster, placement, chaos and watchtower parity
tests (``tests/test_torch_{cluster,placement,chaos,watchtower}.py``).

Each package is one namespace (``PKGS``: the reference, then the port) so
a test builds the same scenario in both with one function and compares
plain data.  The port prices with the H100's constants; the ``v5e``
fixture sets them to the reference's so both run the same arithmetic.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.chaos as JX  # noqa: E402
import repro.cluster as JC  # noqa: E402
import repro.obs as JO  # noqa: E402
import repro.runtime as JR  # noqa: E402
import repro.traffic as JT  # noqa: E402
import repro_torch.chaos as PX  # noqa: E402
import repro_torch.cluster as PC  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.runtime as PR  # noqa: E402
import repro_torch.traffic as PT  # noqa: E402
from repro.core import types as JTY  # noqa: E402
from repro.obs import trace as jobs  # noqa: E402
from repro.runtime import hwmodel as jhm  # noqa: E402
from repro_torch.core import types as PTY  # noqa: E402
from repro_torch.obs import trace as pobs  # noqa: E402
from repro_torch.runtime import hwmodel as phm  # noqa: E402

torch.set_num_threads(2)
V5E = ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "TDP_W", "IDLE_W")
PKGS = (types.SimpleNamespace(X=JX, C=JC, O=JO, R=JR, T=JT, TY=JTY, hm=jhm,
                              obs=jobs),
        types.SimpleNamespace(X=PX, C=PC, O=PO, R=PR, T=PT, TY=PTY, hm=phm,
                              obs=pobs))
P = PKGS[1]
X = np.zeros((16, 16, 3), "float32")     # the small servers' request


@pytest.fixture(autouse=True)
def v5e(monkeypatch):
    """The port's hardware constants set to the reference's (a test that
    needs the H100's calls ``monkeypatch.undo()``)."""
    for name in V5E:
        monkeypatch.setattr(phm, name, getattr(jhm, name))


def both(fn):
    """``fn(pkg)`` for the reference and the port: ``(ref, port)``."""
    return tuple(fn(k) for k in PKGS)


def make_lut(k, scale=1.0, full_chips=256):
    space = k.TY.ElasticSpace(width_mults=(0.5, 0.75, 1.0),
                              ffn_mults=(0.5, 1.0), depth_mults=(0.5, 1.0))
    terms = k.hm.RooflineTerms(0.02 * scale, 0.008 * scale, 0.004 * scale)
    return k.R.model_lut(space.enumerate(), full_terms=terms,
                         full_chips=full_chips)


def make_nodes(k, capacities, states=None):
    nodes = [k.C.ClusterNode(name=f"n{i}",
                             g_fn=lambda t, c=cap, k=k:
                             k.R.GlobalConstraints(total_chips=c))
             for i, cap in enumerate(capacities)]
    for n, st in zip(nodes, states or []):
        n.state = st
    return nodes


_TINY = {}


def tiny_server(*_node, **kw):
    """A small port ViT behind a warmed DynamicServer on the CPU; every
    replica shares one set of weights, built once."""
    from repro_torch.models.vit import ViTConfig, vit_apply, vit_init
    if not _TINY:
        cfg = ViTConfig(name="t", img_res=16, patch=8, n_layers=2,
                        d_model=32, n_heads=4, d_ff=64, n_classes=4,
                        compute_dtype="float32")
        _TINY["cfg"] = cfg
        _TINY["params"] = vit_init(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    cfg = _TINY["cfg"]
    dims = {"d_model": 32, "d_ff": 64, "n_heads": 4, "n_layers": 2}
    s = PR.DynamicServer(lambda p, x, E: vit_apply(p, x, cfg, E=E)[0],
                         _TINY["params"], dims, device="cpu", **kw)
    s.warm([PTY.SubnetSpec()], example_input=X)
    return s


def live_lut():
    """One subnet at one 1-chip point: the small servers' LUT."""
    return PR.model_lut([PTY.SubnetSpec()],
                        full_terms=phm.RooflineTerms(0.02, 0.008, 0.004),
                        full_chips=2,
                        hw_states=[phm.HwState(chips=1, freq=1.0)])


def two_nodes(n=2, **kw):
    """A port Cluster of ``n`` 2-chip nodes behind the p2c router."""
    nodes = [PC.ClusterNode(name=f"n{i}",
                            g_fn=lambda t: PR.GlobalConstraints(
                                total_chips=2))
             for i in range(n)]
    return PC.Cluster(nodes, router=PC.P2C, **kw)
