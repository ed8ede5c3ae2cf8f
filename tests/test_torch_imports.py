"""The port stands alone: no JAX, no reference package, and entry points
that run on the card unless asked for the CPU."""
import ast
import functools
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.serving.engine, "
            "repro_torch.serving.backends, repro_torch.convert, "
            "repro_torch.kernels.build, repro_torch.models.model, "
            "repro_torch.core.allocator, repro_torch.models.mlp, "
            "repro_torch.serving.hoststore; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _entry_points():
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.model import (init_caches, init_paged_caches,
                                          init_params)
    from repro_torch.serving.backends import make_backend
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("granite-moe-1b-a400m", reduced=True)

    def engine(device, **kw):
        params = init_params(cfg, device="cpu")
        return InferenceEngine(cfg, params,
                               make_backend("static", device="cpu"),
                               EngineConfig(**kw), device=device)

    return {
        "resolve_device": lambda device: resolve_device(device),
        "init_params": lambda device: init_params(cfg, device=device),
        "init_paged_caches":
            lambda device: init_paged_caches(cfg, 4, 16, device=device),
        "init_caches": lambda device: init_caches(cfg, 2, 32, device=device),
        "make_backend_static":
            lambda device: make_backend("static", device=device),
        "make_backend_dynaexq":
            lambda device: make_backend("dynaexq", device=device),
        "make_backend_fp16":
            lambda device: make_backend("fp16", device=device),
        "make_backend_offload":
            lambda device: make_backend("offload", device=device),
        "InferenceEngine": engine,
        "InferenceEngine_dense_padded": functools.partial(
            engine, paged=False, moe_dispatch="padded"),
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_params",
                                  "init_paged_caches", "make_backend_static",
                                  "make_backend_dynaexq", "make_backend_fp16",
                                  "make_backend_offload", "InferenceEngine",
                                  "init_caches",
                                  "InferenceEngine_dense_padded"])
def test_entry_points_need_cuda_unless_cpu_is_asked(name):
    fn = _entry_points()[name]
    fn("cpu")                                  # the CPU on request works
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(None)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run alone (no repository beside it) it must fail and print no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
