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
from torch_threads import _one_thread  # noqa: F401

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
            "repro_torch.models.ssm, "
            "repro_torch.serving.hoststore, repro_torch.serving.sampler, "
            "repro_torch.serving.prefix, repro_torch.serving.scheduler, "
            "repro_torch.serving.lobanks, repro_torch.serving.requests, "
            "repro_torch.serving.streaming, repro_torch.fault.inject, "
            "repro_torch.fault.retry, repro_torch.quant.ptq, "
            "repro_torch.quant.sensitivity, repro_torch.obs, "
            "repro_torch.obs.costmodel, repro_torch.launch.roofline, "
            "repro_torch.launch.serve, repro_torch.training, "
            "repro_torch.training.quality, repro_torch.launch.train, "
            "repro_torch.launch.dist, repro_torch.launch.mesh; "
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
    from repro_torch.launch import serve, train
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("granite-moe-1b-a400m", reduced=True)

    def engine(device, obs=None, **kw):
        params = init_params(cfg, device="cpu")
        return InferenceEngine(cfg, params,
                               make_backend("static", device="cpu"),
                               EngineConfig(**kw), device=device, obs=obs)

    def launch_train(device):
        return train.main(["--steps", "1", "--batch", "2", "--seq", "9"] +
                          ([] if device is None else ["--device", device]))

    def launch(device):
        argv = ["--backend", "static", "--batch", "1", "--prompt-len", "8",
                "--new-tokens", "2", "--no-spec"]
        return serve.main(argv + ([] if device is None
                                  else ["--device", device]))

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
        "InferenceEngine_observed":
            lambda device: engine(device, obs=Observability()),
        "launch_serve": launch,
        "launch_train": launch_train,
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_params",
                                  "init_paged_caches", "make_backend_static",
                                  "make_backend_dynaexq", "make_backend_fp16",
                                  "make_backend_offload", "InferenceEngine",
                                  "init_caches",
                                  "InferenceEngine_dense_padded",
                                  "InferenceEngine_observed",
                                  "launch_serve", "launch_train"])
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
