"""Guards on the port: it imports neither JAX nor the reference package,
its entry points never fall back to the CPU silently, and the kernel
wrappers refuse devices they have no kernel for."""
import ast
import pathlib

import pytest
import torch

from repro_torch import convert
from repro_torch.config.registry import get_config
from repro_torch.kernels.block_attention import cached_block_attention_kernel
from repro_torch.kernels.confidence import fused_confidence_kernel
from repro_torch.kernels.fused_step import fused_step_kernel
from repro_torch.launch import serve
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as M

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_entry_points_refuse_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llada-8b").reduced(num_layers=1, max_d_model=64,
                                         vocab_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache_lib.init_kv_cache(1, 1, 4, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, seed=0, device="cuda")
    params = M.init_params(cfg, seed=0, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert params["layers"]["wq"].shape == (1, 64, 32)


@pytest.mark.parametrize("device", [[], ["--device", "cuda"]])
def test_serve_refuses_silent_cpu_fallback(monkeypatch, device):
    """The launcher serves on CUDA unless ``--device cpu`` is given: without
    CUDA it raises before reading the checkpoint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--ckpt", "absent.msgpack"] + device)
    with pytest.raises(FileNotFoundError):
        serve.main(["--ckpt", "absent.msgpack", "--device", "cpu"])


def test_kernel_wrappers_refuse_other_devices():
    meta = dict(device="meta")
    q = torch.empty((1, 4, 2, 32), **meta)
    c = torch.empty((1, 8, 2, 32), **meta)
    b = torch.empty((1, 4, 2, 32), **meta)
    pos = torch.empty((8,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        cached_block_attention_kernel(
            q, c, c, b, b, pos, torch.empty((5, 1), dtype=torch.int32,
                                            **meta))
    with pytest.raises(ValueError):
        fused_confidence_kernel(torch.empty((2, 10), **meta))
    with pytest.raises(ValueError):
        fused_step_kernel(torch.empty((2, 8), **meta),
                          torch.empty((8, 10), **meta),
                          torch.empty((2,), **meta),
                          torch.empty((2,), dtype=torch.bool, **meta),
                          tied=False)
    with pytest.raises(ValueError):
        fused_step_kernel(torch.zeros((6, 8)), torch.zeros((8, 10)),
                          torch.zeros(6), torch.ones(6, dtype=torch.bool),
                          tied=False, quota=2, group=4)
