"""Smoke-run gate for the port's examples (``examples/*_torch.py``), as
``tests/test_examples.py`` gates the JAX ones: each runs as a
subprocess on the CPU at reduced scale and must exit 0 with the
reference's stage markers on stdout; a second ``train_basecaller``
run into the same checkpoint directory resumes from its checkpoint.
"""
import ast
import os
import pathlib
import subprocess
import sys

from _torch_threads import SUBPROCESS_ENV

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run_example(script: str, args) -> str:
    env = dict(os.environ, **SUBPROCESS_ENV)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(ROOT))
    assert res.returncode == 0, (
        f"{script} exited {res.returncode}\n--- stdout ---\n{res.stdout}"
        f"\n--- stderr ---\n{res.stderr}")
    return res.stdout


def _rows(out: str) -> list:
    return [ast.literal_eval(line) for line in out.splitlines()
            if line.startswith("{")]


def test_quickstart_runs_end_to_end():
    out = _run_example("quickstart_torch.py", ["--search-steps", "2",
                                               "--train-steps", "8",
                                               "--serve-reads", "4"])
    assert "QABAS search" in out
    assert "step 8: ctc loss" in out
    assert "read identity on fresh reads" in out
    assert "BasecallerRunner" in out        # serves through the engine
    assert "served 4 reads" in out
    assert out.strip().endswith("done.")


def test_serve_quantized_lm_runs_end_to_end():
    out = _run_example("serve_quantized_lm_torch.py",
                       ["--requests", "4", "--tokens", "6",
                        "--prompt-len", "6"])
    assert "engine bf16" in out and "engine int8" in out
    assert "H100 projection" in out
    # qwen1.5-4b's 3.95 B parameters over 3.35 TB/s, in bf16
    assert "bf16 2.36 ms -> int8 1.18 ms (2.00x)" in out
    assert out.strip().endswith("done.")


def test_train_basecaller_checkpoints_and_resumes(tmp_path):
    ckpt = ["--ckpt-dir", str(tmp_path)]
    out = _run_example("train_basecaller_torch.py", ["--steps", "100",
                                                     *ckpt])
    assert [r["step"] for r in _rows(out)] == [25, 50, 75, 100]
    assert "held-out read identity:" in out
    assert (tmp_path / "step_0000000100").is_dir()
    # the second run resumes at the step-100 checkpoint: only its own
    # steps 101-110 run, so its one logged row is step 110
    out = _run_example("train_basecaller_torch.py", ["--steps", "110",
                                                     *ckpt])
    assert [r["step"] for r in _rows(out)] == [110]
    assert "held-out read identity:" in out
