"""The port stands alone: no JAX, nothing of the reference package, no
silent CPU fallback.

* A fresh interpreter imports ``repro_torch`` and every submodule and
  finds neither ``jax`` nor any ``repro``/``repro.*`` module loaded.
* A source scan of the package and ``chip_smoke.py`` finds no import of
  either.
* Entry points default to the card: without CUDA they raise unless the
  caller asks for the CPU.
* A wrapper given CUDA tensors launches its kernel or raises — it never
  runs the plain version instead.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
import torch
assert torch.get_default_dtype() == torch.float32, torch.get_default_dtype()
print("ISOLATED", len(names))
"""


def test_import_pulls_in_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
    assert int(out.stdout.split()[-1]) >= 20  # every submodule was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch))", re.M)


def test_sources_import_no_jax_and_no_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files
                 if _FORBIDDEN.search(f.read_text(encoding="utf-8"))]
    assert not offenders


def test_every_submodule_is_importable_here():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels._build" in names
    assert "repro_torch.convert" in names
    for mod in ("optimizer", "data", "checkpoint", "compression",
                "train_loop", "async_dp", "diloco"):
        assert f"repro_torch.training.{mod}" in names
    assert {"repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.launch.async_dp_lm"} <= set(names)


#: the launch tools and examples, imported with jax and repro blocked
LAUNCH_MODULES = (
    "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
    "repro_torch.launch.inputs", "repro_torch.launch.roofline",
    "repro_torch.launch.opstats", "repro_torch.launch.dryrun",
    "repro_torch.examples.quickstart", "repro_torch.examples.serve_batched",
    "repro_torch.examples.train_lm", "repro_torch.examples.diloco_async")

_BLOCKED = r"""
import importlib, sys


class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocked())
for name in sys.argv[1:]:
    importlib.import_module(name)
print("IMPORTED", len(sys.argv) - 1)
"""


def test_launch_tools_and_examples_import_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED, *LAUNCH_MODULES],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == str(len(LAUNCH_MODULES))
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert set(LAUNCH_MODULES) <= names


class TestDevices:
    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert not repro_torch.has_cuda()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.default_device()
        with pytest.raises(RuntimeError):
            repro_torch.JacobiProblem(grid=4)
        with pytest.raises(RuntimeError):
            repro_torch.GarnetMDP(S=10)
        with pytest.raises(RuntimeError):
            _device.resolve_device("cuda")

    def test_default_device_is_cuda_when_present(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert repro_torch.has_cuda()
        dev = repro_torch.default_device()
        assert dev.type == "cuda" and dev.index == 0
        assert _device.resolve_device(None) == dev
        assert _device.resolve_device("cuda") == dev

    def test_cpu_on_request_and_other_devices_refused(self):
        assert _device.resolve_device("cpu").type == "cpu"
        assert repro_torch.JacobiProblem(grid=4, device="cpu").device.type \
            == "cpu"
        with pytest.raises(ValueError):
            _device.resolve_device("meta")


def _tiny_lm():
    from repro_torch.launch import lm_serve

    return lm_serve.make_config("gemma2_2b", reduced=True)


def _training():
    import repro_torch.training.async_dp
    import repro_torch.training.diloco
    import repro_torch.training.train_loop  # noqa: F401

    return repro_torch.training


def _zeros_tree(cfg):
    import numpy as np

    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import model_spec

    return tree_map(lambda s: np.zeros(s.shape, np.float32), model_spec(cfg))


@pytest.mark.parametrize("call", [
    lambda cfg, **kw: repro_torch.models.init_params(cfg, **kw),
    lambda cfg, **kw: repro_torch.models.init_caches(cfg, 2, 8, torch.float32,
                                                     **kw),
    lambda cfg, **kw: repro_torch.convert.lm_params_from_arrays(
        cfg, _zeros_tree(cfg), **kw),
    lambda cfg, **kw: _training().async_dp.GradientWorkersProblem(
        cfg, **kw).model,
    lambda cfg, **kw: _training().diloco.DiLoCoTrainer(
        cfg, _training().diloco.DiLoCoConfig(), **kw).model,
    lambda cfg, **kw: _training().train_loop.train(
        cfg, _training().train_loop.TrainConfig(steps=1, batch=2, seq=4),
        log=None, **kw)["params"],
], ids=["init_params", "init_caches", "lm_params_from_arrays", "async_dp",
        "diloco", "train"])
def test_lm_entry_points_default_to_the_card(monkeypatch, call):
    """Without ``device=`` the LM entry points target the card (and raise
    without one); the CPU is taken only on request."""
    import repro_torch.convert  # noqa: F401
    import repro_torch.models  # noqa: F401

    cfg = _tiny_lm()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(cfg)
    out = call(cfg, device="cpu")
    tensors = (list(out.parameters()) if isinstance(out, torch.nn.Module)
               else [c.k for c in out])
    assert tensors and all(t.device.type == "cpu" for t in tensors)


class _CudaStub:
    """Stands in for a CUDA tensor (this host has none): only the device
    and shape, which is all a wrapper reads before it launches."""

    def __init__(self, *shape, requires_grad=False):
        self.shape = torch.Size(shape)
        self.ndim = len(shape)
        self.device = torch.device("cuda", 0)
        self.dtype = torch.float32
        self.requires_grad = requires_grad

    def stride(self, dim):
        return 1


@pytest.fixture
def no_plain(monkeypatch):
    """Make every plain version fail loudly if a wrapper reaches it."""
    for name in ops.KERNELS:
        def forbidden(*a, _name=name, **k):
            raise AssertionError(f"plain {_name} ran for CUDA inputs")
        monkeypatch.setattr(ref, name, forbidden)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda S: ops.jacobi_sweep(S(16), S(16), 4),
    lambda S: ops.jacobi_halo_sweeps(S(2, 4), S(4), S(4), S(2, 4), sweeps=2),
    lambda S: ops.bellman(S(3, 2, 2), S(3, 2, 2), S(3, 2), S(3), gamma=0.9),
    lambda S: ops.bellman_block(S(3, 2, 2), S(3, 2, 2), S(3, 2), S(7), S(3),
                                gamma=0.9),
    lambda S: ops.anderson_mix(S(3, 8), S(3, 8), S(3), beta=0.5),
    lambda S: ops.flash_attention(S(1, 8, 4, 16), S(1, 8, 2, 16),
                                  S(1, 8, 2, 16), window=4, softcap=50.0),
    lambda S: ops.selective_scan(S(2, 5, 32), S(2, 5, 32), S(2, 5, 16),
                                 S(2, 5, 16), S(32, 16), chunk=4),
], ids=["jacobi_sweep", "jacobi_halo_sweeps", "bellman", "bellman_block",
        "anderson_mix", "flash_attention", "selective_scan"])
def test_cuda_inputs_never_take_the_plain_version(no_plain, call):
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        call(_CudaStub)
    assert ops.launch_counts() == before  # nothing launched, nothing counted


def test_flash_refuses_cuda_inputs_that_require_grad(no_plain):
    """The kernel's output is invisible to autograd, so a CUDA call that
    autograd would record raises before anything launches; under
    ``no_grad`` the same inputs go on to the launcher."""
    q = _CudaStub(1, 8, 4, 16, requires_grad=True)
    kv = _CudaStub(1, 8, 2, 16)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, kv, kv)
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(q, kv, kv)
    assert ops.launch_counts() == before


def test_selective_scan_refuses_cuda_inputs_that_require_grad(no_plain):
    """As flash: a CUDA scan that autograd would record raises before
    anything launches (training takes the plain scan)."""
    dt = _CudaStub(2, 5, 32, requires_grad=True)
    bc, A = _CudaStub(2, 5, 8), _CudaStub(32, 8)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.selective_scan(dt, dt, bc, bc, A)
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA"):
        ops.selective_scan(dt, dt, bc, bc, A)
    assert ops.launch_counts() == before


def test_mixed_devices_are_refused():
    x = torch.zeros(16, dtype=torch.float64)
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        ops.jacobi_sweep(x, _CudaStub(16), 4)


def test_cpu_calls_count_no_launches():
    ops.reset_launch_counts()
    x = torch.zeros(16, dtype=torch.float64)
    ops.jacobi_sweep(x, x, 4)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
