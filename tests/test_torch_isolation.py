"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (``repro``), and its entry points run on CUDA unless the caller
asks for the CPU — without a card they raise instead of falling back."""
import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "examples").glob("*_torch.py")))


def _modules():
    """Every module of the port, a package by its own name."""
    names = set()
    for p in PORT.rglob("*.py"):
        parts = p.relative_to(ROOT / "src").with_suffix("").parts
        names.add(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(names)


def _reference_names(path: Path):
    """The names a reference ``__init__`` re-exports, read with ``ast``:
    its ``__all__``, else every name its imports bind (none where the
    file holds only a docstring or does not exist)."""
    if not path.exists():
        return []
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


INITS = ["", "analysis", "configs", "core", "core/qabas", "core/quant",
         "kernels", "serving"]


@pytest.mark.parametrize("package", INITS, ids=lambda p: p or "repro_torch")
def test_package_init_re_exports_the_reference_s_names(package):
    """Each package ``__init__`` of the port exports what its twin does
    (``src/repro/__init__.py`` does not exist: the top level exports
    nothing), and every exported name resolves."""
    want = _reference_names(ROOT / "src" / "repro" / package / "__init__.py")
    name = ".".join(["repro_torch", *filter(None, package.split("/"))])
    mod = importlib.import_module(name)
    assert list(mod.__all__) == list(want)
    assert all(hasattr(mod, n) for n in mod.__all__)
    assert (PORT / package / "__init__.py").read_text().startswith('"""')


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = "\n".join([
        "import importlib, sys",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for m in {_modules()!r}: importlib.import_module(m)",
        "import chip_smoke",
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    from repro_torch.config import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rubicall-smoke")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_serving_engine(params, cfg, n_slots=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "rubicall", "--smoke", "--requests", "1"])
    # the LM path too: its weights are drawn on the card by default
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen1.5-4b", "--smoke", "--requests", "1"])
    # the knob search, and the examples, whose main runs in process here
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen1.5-4b", "--smoke", "--knob-search"])
    for example in sorted((ROOT / "examples").glob("*_torch.py")):
        spec = importlib.util.spec_from_file_location(example.stem, example)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(0, get_config("qwen1.5-4b-smoke"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(0, get_config("deepseek-v3-671b-smoke"), wbits=8)
    # weights bridged from numpy land on the card unless asked otherwise
    from repro_torch import bridge
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.from_numpy_tree({"w": np.zeros((2, 2), np.float32)})
    assert bridge.from_numpy_tree({"w": np.zeros((2, 2), np.float32)},
                                  device="cpu")["w"].device.type == "cpu"
    assert chip_smoke.main() != 0
    # the analyzer records its tick programs on the card; its AST rules
    # need no device
    from repro_torch.analysis import cli as analysis_cli
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis_cli.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis_cli.main(["--rules", "trace-stability"])
    assert analysis_cli.main(["--rules", "compat,host-sync"]) == 0
    # asking for the CPU works, and serves a read there
    eng = api.make_serving_engine(params, cfg, device="cpu", n_slots=1)
    assert eng.runner.device.type == "cpu"
    from repro_torch.serving.engine import Request
    eng.submit(Request(rid=0, signal=np.random.RandomState(0).randn(
        500).astype(np.float32)))
    assert eng.run()[0].status == "finished"


def test_cache_pool_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``CachePool`` without a device resolves to CUDA, and so raises
    without a card; ``device="cpu"`` builds the pool on the CPU."""
    from repro_torch.config import get_config
    from repro_torch.serving.cache import CachePool
    cfg = get_config("qwen1.5-4b-smoke")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CachePool(cfg, 2, 16, torch.float32, block_len=4)
    pool = CachePool(cfg, 2, 16, torch.float32, block_len=4, device="cpu")
    assert pool.device.type == "cpu"
    assert all(a.device.type == "cpu" for tree in pool.caches.values()
               for a in tree.values())
