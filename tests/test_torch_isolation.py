"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (``repro``), and its entry points run on CUDA unless the caller
asks for the CPU — without a card they raise instead of falling back."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  for p in PORT.rglob("*.py"))


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
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(0, get_config("qwen1.5-4b-smoke"))
    assert chip_smoke.main() != 0
    # asking for the CPU works, and serves a read there
    eng = api.make_serving_engine(params, cfg, device="cpu", n_slots=1)
    assert eng.runner.device.type == "cpu"
    from repro_torch.serving.engine import Request
    eng.submit(Request(rid=0, signal=np.random.RandomState(0).randn(
        500).astype(np.float32)))
    assert eng.run()[0].status == "finished"
