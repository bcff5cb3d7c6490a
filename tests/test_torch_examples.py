"""The reference's examples on the port, on the CPU:
``repro_torch.examples.quickstart`` at the example's own sizes,
``grow_pipeline`` at a few steps a stage, ``train_100m``'s configs and
flags against ``examples/train_100m.py``, ``serve_continuous``'s tokens
against the reference example's engine runs and ``serve_batched``'s
against the reference example's ``generate`` (the examples loaded by
path, not edited)."""
import sys

import jax
import numpy as np
import pytest

from _torch_port import port_config, reference_example
from repro.configs.base import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.convert import from_jax
from repro_torch.examples import (
    grow_pipeline,
    quickstart,
    serve_batched,
    serve_continuous,
    train_100m,
)


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


def test_serve_continuous_serves_the_reference_examples_tokens(capsys):
    """The three models of ``examples/serve_continuous.py`` with the
    reference's weights (JAX's seed-0 inits, gpt-micro-big grown by JAX's
    ``build_params``; converted) and its traces, requests and engine
    sizes: every request's tokens equal the reference engine's."""
    from repro.launch.serve import build_params as jax_build_params
    from repro.models import get_family as jax_family
    from repro.serve import ContinuousBatchingEngine as JaxEngine

    ref_mod = reference_example("serve_continuous")
    want, params = {}, {}
    for name, n, max_len in serve_continuous.MODELS:
        jcfg = jax_get_config(name)
        if name in serve_continuous.GROWN_FROM:
            jp = jax_build_params(jcfg, grow_from=serve_continuous.GROWN_FROM[
                name], grow_method="mango", grow_steps=0,
                log_fn=lambda *a, **k: None)
        else:
            jp = jax_family(jcfg).init(jax.random.PRNGKey(0), jcfg)
        jp = jax.tree.map(np.asarray, jp)
        params[name] = from_jax(jp)
        reqs = ref_mod.mixed_trace(jcfg, n)
        ours = serve_continuous.mixed_trace(get_config(name), n)
        assert [(r.uid, r.max_new_tokens, list(r.prompt)) for r in ours] == \
            [(r.uid, r.max_new_tokens, list(r.prompt)) for r in reqs]
        want[name] = JaxEngine(jcfg, jp, capacity=4, max_len=max_len).run(
            reqs)
    got = serve_continuous.main(["--device", "cpu"], params=params)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for uid in want[name]:
            np.testing.assert_array_equal(np.asarray(got[name][uid]),
                                          np.asarray(want[name][uid]),
                                          err_msg=f"{name} uid {uid}")
    out = capsys.readouterr().out
    assert "recurrent+ring slots, attn ring=32 of window=32" in out
    assert "on Mango-grown params from gpt-micro" in out


def test_serve_batched_generates_the_reference_examples_tokens(capsys):
    """The three configs of ``examples/serve_batched.py`` with the
    reference's weights (JAX's seed-0 inits, converted) and prompts: every
    row's 12 tokens equal JAX's ``generate``, and each printed sample row
    equals the reference example's."""
    from repro.data.synthetic import lm_batch as jax_lm_batch
    from repro.launch.serve import generate as jax_generate
    from repro.models import get_family as jax_family

    ref_mod = reference_example("serve_batched")
    ref_mod.main()
    ref_rows = [ln.split("sample row:")[1].strip()
                for ln in capsys.readouterr().out.splitlines()
                if "sample row:" in ln]
    want, params = {}, {}
    for name in serve_batched.ARCHS:
        jcfg = jax_get_config(name)
        jp = jax.tree.map(np.asarray, jax_family(jcfg).init(
            jax.random.PRNGKey(0), jcfg))
        params[name] = from_jax(jp)
        want[name] = np.asarray(jax_generate(
            jcfg, jp, jax_lm_batch(jcfg.vocab_size, 4, 24),
            max_new_tokens=12))
    got = serve_batched.main(["--device", "cpu"], params=params)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    rows = [ln.split("sample row:")[1].strip()
            for ln in capsys.readouterr().out.splitlines()
            if "sample row:" in ln]
    assert rows == ref_rows
