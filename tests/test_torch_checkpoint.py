"""The port's checkpoints against the JAX package's on the CPU: the same
on-disk format both ways (bf16 leaves bit for bit), the same manifests,
the loader's refusals, keep-K GC, async saves, and the train launcher's
resume and grow-from-checkpoint across both packages.

Trees are gpt-micro params made by JAX (or small seeded numpy trees);
training runs at batch 2 x 16 tokens.  Tolerances are stated per test.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, jax_params
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs.base import get_config as jax_get_config
from repro.launch import train as jax_train
from repro.utils import pytree as jax_pytree
from repro_torch.checkpoint import (
    CheckpointManager,
    CheckpointShapeError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.convert import from_jax, to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.utils.pytree import (
    tree_flatten_with_paths,
    tree_param_count,
    tree_size_bytes,
)

TRAIN = dict(batch=2, seq=16, lr=3e-3, warmup=2)  # both launchers


def _mixed_tree(seed=0):
    """gpt-micro params (f32) beside bf16 and int32 leaves, as numpy (the
    bf16 leaf as ml_dtypes' bfloat16, which JAX saves as raw void
    bytes)."""
    rng = np.random.default_rng(seed)
    p = jax_params(jax_get_config("gpt-micro"), seed=seed)
    return {"p": p, "o": {
        "half": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
        "count": np.arange(6, dtype=np.int32).reshape(2, 3)}}


def _bits(t):
    """A float's raw bit pattern (bf16 as int16, float8 as int8), for
    exact equality."""
    if not t.dtype.is_floating_point:
        return t
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _assert_bit_equal(got, want):
    g, w = dict(tree_flatten_with_paths(got)), dict(
        tree_flatten_with_paths(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(_bits(g[k]), _bits(w[k])), k


def _manifest(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.float8_e4m3fn])
def test_port_round_trip(tmp_path, dtype):
    """Save then load gives the same bits, dtype and structure; ``extra``
    comes back; a ``None`` subtree stays ``None``."""
    gen = torch.Generator().manual_seed(0)
    tree = {"a": {"w": torch.randn(4, 3, generator=gen)},
            "b": torch.randn(7, generator=gen) * 100}
    tree = {k: (v.to(dtype) if torch.is_tensor(v) else
                {kk: vv.to(dtype) for kk, vv in v.items()})
            for k, v in tree.items()}
    save_checkpoint(str(tmp_path), 5, tree, extra={"arch": "x"})
    got, step, extra = load_checkpoint(str(tmp_path),
                                       {**tree, "none": None})
    assert (step, extra, got["none"]) == (5, {"arch": "x"}, None)
    del got["none"]
    _assert_bit_equal(got, tree)


def test_jax_writes_port_restores_bf16_bit_for_bit(tmp_path):
    tree = _mixed_tree(1)
    jax_save(str(tmp_path), 3, tree, extra={"arch": "gpt-micro"})
    template = from_jax(jax.tree.map(np.zeros_like, tree))
    got, step, extra = load_checkpoint(str(tmp_path), template)
    assert (step, extra) == (3, {"arch": "gpt-micro"})
    _assert_bit_equal(got, from_jax(tree))


def test_port_writes_jax_restores_bf16_bit_for_bit(tmp_path):
    tree = _mixed_tree(2)
    save_checkpoint(str(tmp_path), 4, from_jax(tree), extra={"k": 1})
    got, step, extra = jax_load(str(tmp_path),
                                jax.tree.map(np.zeros_like, tree))
    assert (step, extra) == (4, {"k": 1})
    assert got["o"]["half"].dtype == jnp.bfloat16
    _assert_bit_equal(from_jax(jax.tree.map(np.asarray, got)),
                      from_jax(tree))


def test_manifests_agree(tmp_path):
    """For one tree both packages write the same leaf names, files, shapes,
    dtype strings and CRC32s, and the same bytes in each file's array (the
    npy headers differ only in a bf16 leaf's byte-order mark: "<V2" from
    ml_dtypes, "|V2" from a plain void array; numpy reads both as V2)."""
    tree = _mixed_tree(3)
    jax_save(str(tmp_path / "jax"), 7, tree)
    save_checkpoint(str(tmp_path / "port"), 7, from_jax(tree))
    want = _manifest(str(tmp_path / "jax"), 7)
    assert _manifest(str(tmp_path / "port"), 7) == want
    assert "p.dense_blocks.attn.wq" in want["leaves"]
    assert want["leaves"]["o.half"]["dtype"] == "bfloat16"
    for meta in want["leaves"].values():
        a, b = (tmp_path / side / "step_0000000007" / meta["file"]
                for side in ("jax", "port"))
        a, b = np.load(a), np.load(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), meta


def test_tree_counts_equal_jax():
    """``tree_param_count`` and ``tree_size_bytes`` over a tree with a
    ``None`` subtree (an empty subtree, not a leaf) equal JAX's."""
    tree = {**_mixed_tree(4), "none": None}
    ported = from_jax({k: v for k, v in tree.items() if v is not None})
    ported["none"] = None
    assert tree_param_count(ported) == jax_pytree.tree_param_count(tree)
    assert tree_size_bytes(ported) == jax_pytree.tree_size_bytes(tree)


def test_crc_mismatch_raises_ioerror(tmp_path):
    tree = from_jax(_mixed_tree(5))
    save_checkpoint(str(tmp_path), 1, tree)
    meta = _manifest(str(tmp_path), 1)["leaves"]["p.embed"]
    path = tmp_path / "step_0000000001" / meta["file"]
    arr = np.load(path)
    arr[0, 0] += 1.0
    np.save(path, arr)
    with pytest.raises(IOError, match="checksum mismatch for p.embed"):
        load_checkpoint(str(tmp_path), tree)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_geometry_mismatch_names_the_leaf(tmp_path, fault):
    tree = from_jax(_mixed_tree(6))
    template = from_jax(_mixed_tree(6))
    if fault == "missing":
        del tree["p"]["final_norm"]["bias"]
        leaf = "p.final_norm.bias"
    else:
        template["p"]["pos_embed"] = torch.zeros(300, 64)
        leaf = "p.pos_embed"
    save_checkpoint(str(tmp_path), 2, tree)
    with pytest.raises(CheckpointShapeError, match=leaf.replace(".", r"\."))\
            as err:
        load_checkpoint(str(tmp_path), template)
    assert err.value.leaf == leaf


def test_leaves_the_template_lacks_are_ignored(tmp_path):
    """A source checkpoint holds ``p`` and ``o``; growth reads ``p`` only,
    cast to the template's dtype and placed on its device."""
    tree = from_jax(_mixed_tree(7))
    save_checkpoint(str(tmp_path), 9, tree)
    half = {k: v.bfloat16() for k, v in tree["p"]["final_norm"].items()}
    got, _, _ = load_checkpoint(str(tmp_path),
                                {"p": {"final_norm": half}, "o": None})
    assert got["o"] is None
    for k, v in got["p"]["final_norm"].items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, tree["p"]["final_norm"][k].bfloat16())


def test_latest_step_ignores_tmp_and_manifestless_dirs(tmp_path):
    tree = {"w": torch.ones(2)}
    save_checkpoint(str(tmp_path), 3, tree)
    (tmp_path / "tmp.9").mkdir()
    (tmp_path / "step_0000000008").mkdir()  # a crash before the manifest
    assert latest_step(str(tmp_path)) == 3
    assert load_checkpoint(str(tmp_path), tree)[1] == 3
    assert latest_step(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_keeps_three_and_saves_every_n(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), keep=3, every=2,
                            async_save=async_save)
    saved = [s for s in range(1, 11)
             if mgr.maybe_save(s, {"w": torch.full((3,), float(s))})]
    assert mgr.maybe_save(11, {"w": torch.zeros(3)}, force=True)
    mgr.wait()
    assert saved == [2, 4, 6, 8, 10]
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{s:010d}" for s in (8, 10, 11)]
    assert [s["step"] for s in mgr.saves] == [2, 4, 6, 8, 10, 11]
    assert all(s["bytes"] == 12 for s in mgr.saves)
    got, step, _ = mgr.restore_latest({"w": torch.ones(3)})
    assert step == 11 and torch.equal(got["w"], torch.zeros(3))


def test_async_save_snapshots_cpu_tensors(tmp_path):
    """The snapshot is taken on the caller's thread: an in-place update
    right after ``maybe_save`` never reaches the file."""
    w = torch.zeros(1 << 16)
    mgr = CheckpointManager(str(tmp_path), every=1, async_save=True)
    mgr.maybe_save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    got, _, _ = load_checkpoint(str(tmp_path), {"w": w})
    assert torch.equal(got["w"], torch.zeros(1 << 16))


def test_failed_async_save_reraises(tmp_path):
    """A save that fails on the worker thread raises on ``wait()``, and a
    second one on the next ``maybe_save``."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    mgr = CheckpointManager(str(blocker), every=1, async_save=True)
    mgr.maybe_save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error was raised once
    mgr.maybe_save(2, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.maybe_save(3, {"w": torch.ones(2)})


def _port_train(steps, ckpt_dir, **kw):
    logs = []
    params, hist = launch_train.train(
        "gpt-micro", steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=3,
        log_every=1, device="cpu", log_fn=logs.append, **TRAIN, **kw)
    return params, hist, logs


def _jax_train(steps, ckpt_dir, **kw):
    logs = []
    params, hist = jax_train.train(
        "gpt-micro", steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=3,
        log_every=1, log_fn=logs.append, **TRAIN, **kw)
    return jax.tree.map(np.asarray, params), hist, logs


def _copy_step(src_dir, dst_dir, step):
    name = f"step_{step:010d}"
    shutil.copytree(os.path.join(src_dir, name), os.path.join(dst_dir, name))


def test_port_resume_equals_straight_run_bit_for_bit(tmp_path):
    """Six straight steps (saving at 3 and 6) against a resume from the
    step-3 checkpoint to 6: params, optimizer state and logged losses are
    equal bit for bit."""
    straight, hist, _ = _port_train(6, tmp_path / "a")
    _copy_step(tmp_path / "a", tmp_path / "b", 3)
    resumed, rhist, logs = _port_train(6, tmp_path / "b", resume=True)
    assert "[resume] restored step 3" in logs
    assert [h["step"] for h in rhist] == [3, 4, 5]
    assert [h["loss"] for h in rhist] == [h["loss"] for h in hist[3:]]
    _assert_bit_equal(resumed, straight)
    assert _manifest(str(tmp_path / "b"), 6) == _manifest(
        str(tmp_path / "a"), 6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_frameworks(tmp_path, writer):
    """One package trains 6 steps (saving at 3 and 6); the other resumes
    from the step-3 checkpoint: its losses at steps 3-5 equal the writer's
    (1e-5 relative) and its final params the writer's (1e-4, the
    trajectory tolerance of test_torch_train)."""
    if writer == "jax":
        want, hist, _ = _jax_train(6, tmp_path / "w")
    else:
        params, hist, _ = _port_train(6, tmp_path / "w")
        want = to_numpy(params)
    _copy_step(tmp_path / "w", tmp_path / "r", 3)
    if writer == "jax":
        params, rhist, logs = _port_train(6, tmp_path / "r", resume=True)
        got = to_numpy(params)
    else:
        got, rhist, logs = _jax_train(6, tmp_path / "r", resume=True)
    assert "[resume] restored step 3" in logs
    assert [h["step"] for h in rhist] == [3, 4, 5]
    for g, w in zip(rhist, hist[3:]):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    g, w = (dict(tree_flatten_with_paths(t)) for t in (got, want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=k)


def test_grow_from_checkpoint_equals_jax(tmp_path):
    """JAX pretrains gpt-micro into ``<root>/gpt-micro``; both launchers
    then grow gpt-micro-big (bert2BERT, no operator or train steps) with
    ``ckpt_dir=<root>/gpt-micro-big``: each logs the source line, and the
    grown params each saves at step 0 agree (2e-5)."""
    _jax_train(2, tmp_path / "jax" / "gpt-micro")
    shutil.copytree(tmp_path / "jax" / "gpt-micro",
                    tmp_path / "port" / "gpt-micro")
    grow = dict(grow_from="gpt-micro", grow_method="bert2bert",
                grow_steps=0, steps=0)
    # the reference finds the sibling only once ckpt_dir exists (ROADMAP
    # §3); the port resolves it without
    (tmp_path / "jax" / "gpt-micro-big").mkdir()
    jlogs, logs = [], []
    jax_train.train("gpt-micro-big", ckpt_dir=str(
        tmp_path / "jax" / "gpt-micro-big"), log_fn=jlogs.append, **grow)
    launch_train.train("gpt-micro-big", ckpt_dir=str(
        tmp_path / "port" / "gpt-micro-big"), device="cpu",
        log_fn=logs.append, **grow)
    src = os.path.normpath(tmp_path / "port" / "gpt-micro")
    assert f"[grow] source weights from {src} @ step 2" in logs
    assert any(m.startswith("[grow] source weights from") and
               m.endswith("@ step 2") for m in jlogs)
    want = _manifest(str(tmp_path / "jax" / "gpt-micro-big"), 0)["leaves"]
    assert _manifest(str(tmp_path / "port" / "gpt-micro-big"), 0)[
        "leaves"].keys() == want.keys()
    for name in (n for n in want if n.startswith("p.")):
        a, b = (np.load(tmp_path / side / "gpt-micro-big" /
                        "step_0000000000" / want[name]["file"])
                for side in ("jax", "port"))
        np.testing.assert_allclose(b, a, atol=F32_ATOL, err_msg=name)


def test_sibling_rule_without_an_existing_ckpt_dir(tmp_path):
    """Where ``ckpt_dir`` does not exist yet, the reference's stat of
    ``<ckpt_dir>/../<grow_from>`` fails and it grows from a fresh source;
    the port resolves the path lexically and finds the checkpoint."""
    _port_train(1, tmp_path / "gpt-micro")
    grow = dict(grow_from="gpt-micro", grow_method="bert2bert",
                grow_steps=0, steps=0)
    jlogs, logs = [], []
    jax_train.train("gpt-micro-big", ckpt_dir=str(
        tmp_path / "jax-big"), log_fn=jlogs.append, **grow)
    launch_train.train("gpt-micro-big", ckpt_dir=str(tmp_path / "port-big"),
                       device="cpu", log_fn=logs.append, **grow)
    assert not any("source weights" in m for m in jlogs)
    assert f"[grow] source weights from {tmp_path / 'gpt-micro'} @ step 1" \
        in logs
