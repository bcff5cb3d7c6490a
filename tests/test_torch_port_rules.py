"""Rules the port keeps: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless asked for the CPU, raising when CUDA
is missing instead of quietly running elsewhere."""
import ast
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_tree_is_what_the_rule_walks():
    assert len(PORT_FILES) > 15
    for module in ("serve/engine.py", "serve/speculative.py",
                   "serve/paged.py", "serve/sampling.py", "serve/recovery.py",
                   "serve/faults.py", "serve/upgrade.py",
                   "kernels/decode_attention.py",
                   "kernels/ops.py", "kernels/ref.py", "kernels/rglru_scan.py",
                   "kernels/build.py", "models/attention.py",
                   "models/transformer.py", "models/griffin.py",
                   "models/rope.py", "models/common.py", "models/xlstm.py",
                   "models/moe.py",
                   "configs/archs.py",
                   "launch/serve.py", "launch/train.py",
                   "checkpoint/manager.py", "data/synthetic.py",
                   "examples/quickstart.py", "examples/grow_pipeline.py",
                   "examples/train_100m.py", "examples/serve_continuous.py",
                   "examples/serve_batched.py"):
        assert ROOT / "src/repro_torch" / module in PORT_FILES


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_choice_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device()  # the default is CUDA
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_need_cuda_unless_asked_for_cpu(no_cuda, capsys):
    cfg = get_config("gpt-micro")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        launch_serve.build_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        launch_serve.main(["--arch", "gpt-micro"])
    params = launch_serve.build_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    launch_serve.main(["--arch", "gpt-micro", "--engine", "continuous",
                       "--batch", "3", "--prompt-len", "8", "--gen", "3",
                       "--capacity", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "on cpu" in out


@pytest.mark.parametrize("argv,flag", [
    (["--mesh", "1x2"], "--mesh"), (["--mesh=2x1"], "--mesh"),
    (["--kernel", "pallas"], "--kernel"), (["--kernel=auto"], "--kernel"),
])
def test_unported_flags_exit_with_a_named_error(argv, flag):
    """Only the mesh and the kernel switch still refuse (``--deadline``
    and ``--faults`` run: ``tests/test_torch_faults.py``)."""
    with pytest.raises(SystemExit, match=f"error: {flag} .*not ported"):
        launch_serve.main(["--arch", "gpt-micro", "--engine", "continuous",
                           "--device", "cpu", *argv])
    assert set(launch_serve.UNPORTED_FLAGS) == {"--mesh", "--kernel"}


SERVE_CPU = ["--arch", "gpt-micro", "--engine", "continuous", "--batch",
             "4", "--prompt-len", "12", "--gen", "8", "--capacity", "2",
             "--k", "2", "--device", "cpu"]


@pytest.mark.parametrize("flag", ["--grow-cfg", "--upgrade-at",
                                  "--upgrade-sync", "--journal", "--resume",
                                  "--snapshot"])
def test_runtime_flags_run_on_cpu(flag, tmp_path, capsys):
    """The live-upgrade and recovery flags run through the launcher:
    ``--grow-cfg`` grows gpt-micro into gpt-micro-big on a background
    thread and swaps it in (at the trace's end if growth outlives it);
    ``--upgrade-at`` / ``--upgrade-sync`` grow first and swap at dispatch
    2 with the two mid-flight requests resumed; ``--journal`` records the
    trace; ``--resume`` finishes a trace whose engine died after one step
    with the uninterrupted run's tokens; ``--snapshot`` writes a snapshot
    that ``restore_engine`` rebuilds."""
    from repro_torch.serve import (
        ContinuousBatchingEngine,
        RequestJournal,
        read_journal,
        restore_engine,
    )

    journal = tmp_path / "j.jsonl"
    extra = {"--grow-cfg": ["--grow-cfg", "gpt-micro-big"],
             "--upgrade-at": ["--grow-cfg", "gpt-micro-big", "--upgrade-sync",
                              "--upgrade-at", "2"],
             "--upgrade-sync": ["--grow-cfg", "gpt-micro-big",
                                "--upgrade-sync"],
             "--journal": ["--journal", str(journal)],
             "--resume": ["--journal", str(journal), "--resume"],
             "--snapshot": ["--snapshot", str(tmp_path / "snap")]}[flag]
    cfg = get_config("gpt-micro")
    params = launch_serve.build_params(cfg, device="cpu")
    reqs = launch_serve.trace_requests(cfg, 4, 12, 8)
    want = ContinuousBatchingEngine(cfg, params, capacity=2, max_len=20,
                                    k=2).run(reqs)
    if flag == "--resume":
        # the crash: one engine iteration, then the engine is dropped
        j = RequestJournal(str(journal))
        eng = ContinuousBatchingEngine(cfg, params, capacity=2, max_len=20,
                                       k=2, journal=j)
        for r in launch_serve.trace_requests(cfg, 4, 12, 8):
            eng.submit(r)
        eng.step()
        j.close()
    launch_serve.main([*SERVE_CPU, *extra])
    out = capsys.readouterr().out
    assert "tokens in" in out and "on cpu" in out
    if flag in ("--grow-cfg", "--upgrade-at", "--upgrade-sync"):
        assert "upgrade SWAPPED: gpt-micro -> gpt-micro-big" in out
        assert "0 dropped" in out
        # a background growth lands wherever it is ready; grown first, the
        # swap lands at dispatch 2 (two requests mid-flight) or at once
        resumed = {"--upgrade-at": "2", "--upgrade-sync": "0"}.get(flag)
        if resumed is not None:
            assert f"{resumed} mid-flight resumed" in out
    elif flag in ("--journal", "--resume"):
        st = read_journal(str(journal))
        assert set(st.finished) == set(want)
        for uid in want:
            np.testing.assert_array_equal(st.committed[uid], want[uid])
        if flag == "--resume":
            assert "re-admitting mid-flight" in out
            assert "--resume: journal replays 4 request(s) — 0 already " \
                "complete, 4 re-admitting" in out
    else:
        assert "engine snapshot ->" in out
        eng = restore_engine(str(tmp_path / "snap"), device="cpu")
        assert (eng.cfg.name, eng.capacity, eng.k, eng.max_len) == (
            "gpt-micro", 2, 2, 20)


def test_serve_grow_serves_a_grown_model_on_cpu(capsys):
    """``--grow`` builds the served params through the growth operator
    (with two operator-training steps) and serves them."""
    launch_serve.main(["--arch", "gpt-micro-big", "--engine", "continuous",
                       "--grow", "gpt-micro", "--grow-steps", "2",
                       "--batch", "2", "--prompt-len", "8", "--gen", "3",
                       "--capacity", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[grow] mango operator trained 2 steps" in out
    assert "served 2 requests / 6 tokens" in out and "on cpu" in out


@pytest.mark.parametrize("example", ["quickstart", "grow_pipeline",
                                     "train_100m"])
def test_examples_need_cuda_unless_asked_for_cpu(no_cuda, example,
                                                 tmp_path):
    """Each example raises before any work when CUDA is asked for (the
    default) and missing."""
    module = importlib.import_module(f"repro_torch.examples.{example}")
    argv = {"quickstart": [], "train_100m": ["--ckpt-dir", str(tmp_path)],
            "grow_pipeline": ["--root", str(tmp_path)]}[example]
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        module.main(argv)
    assert not any(tmp_path.iterdir())


def test_train_launcher_needs_cuda_unless_asked_for_cpu(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        launch_train.main(["--arch", "gpt-micro", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        launch_train.train("gpt-micro", steps=1)
    hist = tmp_path / "hist.json"
    launch_train.main(["--arch", "gpt-micro-big", "--grow-from", "gpt-micro",
                       "--grow-steps", "1", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--device", "cpu",
                       "--history-out", str(hist)])
    assert '"loss"' in hist.read_text()


@pytest.mark.parametrize("flag", ["--ckpt-dir", "--ckpt-every", "--resume"])
def test_train_checkpoint_flags_run_on_cpu(flag, tmp_path, capsys):
    """``--ckpt-dir`` saves (every steps // 4 and at the end),
    ``--ckpt-every`` sets the period, ``--resume`` restarts from the newest
    save."""
    ckpt = tmp_path / "gpt-micro"
    argv = ["--arch", "gpt-micro", "--steps", "4", "--batch", "2", "--seq",
            "8", "--device", "cpu", "--ckpt-dir", str(ckpt)]
    extra = {"--ckpt-dir": [], "--ckpt-every": ["--ckpt-every", "3"],
             "--resume": []}[flag]
    launch_train.main([*argv, *extra])
    saved = {"--ckpt-dir": [2, 3, 4], "--ckpt-every": [3, 4],
             "--resume": [2, 3, 4]}[flag]
    assert sorted(os.listdir(ckpt)) == [f"step_{s:010d}" for s in saved]
    if flag == "--resume":
        launch_train.main([*argv[:3], "6", *argv[4:], "--resume"])
        after = capsys.readouterr().out.split("[resume] restored step 4")
        assert len(after) == 2  # logs steps 4.. (log_every 10): the last
        assert "step     5" in after[1] and "step     0" not in after[1]
        assert sorted(os.listdir(ckpt))[-1] == "step_0000000006"


def test_train_clis_both_reject_grow_src_ckpt(monkeypatch, capsys):
    """``--grow-src-ckpt`` is no flag of the reference's train CLI (only an
    argument of its ``train()``), so argparse rejects it in both CLIs."""
    from repro.launch import train as jax_train

    argv = ["--arch", "gpt-micro", "--grow-src-ckpt=src"]
    with pytest.raises(SystemExit) as port:
        launch_train.main([*argv, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    with pytest.raises(SystemExit) as reference:
        jax_train.main()
    assert port.value.code == reference.value.code == 2
    assert capsys.readouterr().err.count(
        "unrecognized arguments: --grow-src-ckpt=src") == 2


def test_naive_engine_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "gpt-micro", "--batch", "2",
                       "--prompt-len", "5", "--gen", "3", "--device", "cpu"])
    assert "[naive] generated 6 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_cuda_and_prints_no_result(where, tmp_path):
    """Without a card (``CUDA_VISIBLE_DEVICES`` empty), or with nothing of
    the repo beside it, ``chip_smoke.py`` exits non-zero before any result
    line."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    assert "CUDA" in r.stderr


def test_generate_returns_the_prompt_device_and_int32():
    cfg = get_config("gpt-micro")
    params = launch_serve.build_params(cfg, seed=1, device="cpu")
    prompts = torch.from_numpy(np.arange(12, dtype=np.int32).reshape(2, 6))
    toks = launch_serve.generate(cfg, params, prompts, max_new_tokens=4)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert toks.device.type == "cpu"
