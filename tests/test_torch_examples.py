"""The reference's three examples on the port, on the CPU:
``repro_torch.examples.quickstart`` at the example's own sizes,
``grow_pipeline`` at a few steps a stage, and ``train_100m``'s configs and
flags against ``examples/train_100m.py`` (loaded by path, not edited)."""
import sys

import pytest

from _torch_port import port_config, reference_example
from repro.configs.base import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.examples import grow_pipeline, quickstart, train_100m


def test_quickstart_grown_beats_scratch_at_its_own_sizes(capsys):
    """120 pretraining steps, 25 operator steps: the grown gpt-micro-big
    starts below a scratch one on a held-out batch."""
    out = quickstart.main(["--device", "cpu"])
    assert out["grown"] < out["scratch"]
    assert "OK: the grown model inherits" in capsys.readouterr().out


def test_grow_pipeline_grows_from_its_checkpoint_and_resumes(tmp_path):
    """Stage 2 grows from stage 1's checkpoint (the sibling directory) and
    stage 3 resumes stage 2's last save."""
    logs = []
    hist = grow_pipeline.run(str(tmp_path), pretrain_steps=3,
                             grow_train_steps=2, resume_steps=4,
                             grow_steps=1, device="cpu",
                             log_fn=logs.append)
    src = tmp_path / "gpt-micro"
    assert f"[grow] source weights from {src} @ step 3" in logs
    assert "[resume] restored step 2" in logs
    assert [h["step"] for h in hist] == [3]  # the last step; log_every 15
    assert (tmp_path / "gpt-micro-big" / "step_0000000004").is_dir()


@pytest.mark.parametrize("name", ["gpt-100m", "gpt-25m"])
def test_train_100m_configs_equal_the_reference_example(name):
    reference_example("train_100m")
    assert get_config(name) == port_config(jax_get_config(name))


@pytest.mark.parametrize("argv", [[], ["--grow", "--steps", "8",
                                       "--ckpt-dir", "ck"]])
def test_train_100m_flags_equal_the_reference_example(monkeypatch, argv):
    """Both mains make the same ``train`` calls for the same flags (the
    port's with ``device`` besides)."""
    ref = reference_example("train_100m")
    calls = {"ref": [], "port": []}
    monkeypatch.setattr(ref, "train",
                        lambda *a, **kw: calls["ref"].append((a, kw)))
    monkeypatch.setattr(train_100m, "train",
                        lambda *a, **kw: calls["port"].append((a, kw)))
    monkeypatch.setattr(sys, "argv", ["train_100m.py", *argv])
    ref.main()
    train_100m.main([*argv, "--device", "cpu"])
    assert len(calls["port"]) == len(calls["ref"]) == (2 if argv else 1)
    for (pa, pkw), (ra, rkw) in zip(calls["port"], calls["ref"]):
        assert pkw.pop("device") == "cpu"
        assert (pa, pkw) == (ra, rkw)
    if not argv:
        assert calls["port"][0][1]["ckpt_dir"] == "/tmp/repro_100m"
