"""The port's live upgrade (``repro_torch/serve/upgrade.py`` and the
engine's hot swap) against the JAX package's (CPU, converted weights).

Both engines serve gpt-micro and swap in gpt-micro-big (grown by JAX's
Mango at noise 0 and converted) at dispatch 2, on the dense and the paged
pool, and griffin-micro -> griffin-micro-big (grown by the port's Mango
from the converted source, held against JAX's grown weights; the old
griffin then drafts, as in JAX): the same requests are
resumed (uid, prompt, ``n_committed``) and every token is equal to JAX's
and to the split the swap promises -- the committed prefix is the
source's greedy run, the rest the grown model's on prompt ‖ committed.
Then draft-after-swap, a submit held across the swap, the prewarm's
(group, bucket) set against JAX's, the eager named errors (JAX's text),
a failed growth, the manager's own growth against JAX's, the launcher's
upgrade refusals in JAX's words, and the launcher swapping a griffin pair
grown by the port as JAX's swaps it.  The two MoE families
(phi3.5-moe-42b-smoke's K/V groups, deepseek-v3-671b-smoke's latent
ones) swap into their wider MoEs on both pools as JAX's engine does.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_port import F32_ATOL, port_config
from repro.configs.base import get_config as jax_get_config
from repro.core.grow import grow_from_source as jax_grow_from_source
from repro.data.synthetic import lm_batch
from repro.models import get_family as jax_family
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import UpgradeError as JaxUpgradeError
from repro.serve import UpgradeManager as JaxUpgradeManager
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import grow as port_grow
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import generate
from repro_torch.serve import (
    ContinuousBatchingEngine,
    Request,
    UpgradeError,
    UpgradeManager,
)
from repro_torch.utils.pytree import tree_flatten_with_paths

MAX_LEN = 32


def _pair(src, tgt):
    """(JAX cfgs, JAX params, port cfgs, port params) of a source and its
    grown target (JAX's Mango at noise 0), weights converted leaf for
    leaf.  ``src`` and ``tgt`` are config names or JAX configs."""
    jsrc, jtgt = (jax_get_config(c) if isinstance(c, str) else c
                  for c in (src, tgt))
    jp = jax_family(jsrc).init(jax.random.PRNGKey(0), jsrc)
    jg = jax_grow_from_source(jsrc, jtgt, params_src=jp, noise=0.0,
                              log_fn=lambda *a, **k: None)
    jp, jg = (jax.tree.map(np.asarray, t) for t in (jp, jg))
    return ((jsrc, jp, jtgt, jg),
            (port_config(jsrc), from_jax(jp), port_config(jtgt),
             from_jax(jg)))


@pytest.fixture(scope="module")
def gpt_pair():
    return _pair("gpt-micro", "gpt-micro-big")


@pytest.fixture(scope="module")
def griffin_pair():
    """The griffin pair with the port's side grown by the port (Mango
    rank 1, noise 0) from the converted source."""
    jax_pair, port_pair = _pair("griffin-micro", "griffin-micro-big")
    cfg_src, params_src, cfg_tgt, _ = port_pair
    grown = port_grow.grow_from_source(cfg_src, cfg_tgt,
                                       params_src=params_src, noise=0.0,
                                       device="cpu",
                                       log_fn=lambda *a, **k: None)
    return jax_pair, (cfg_src, params_src, cfg_tgt, grown)


def test_griffin_pair_grown_in_port_equals_jax_growth(griffin_pair):
    """The port's griffin growth (``griffin.param_shapes`` on the meta
    device) gives JAX's grown weights leaf for leaf within 2e-5."""
    jax_pair, port_pair = griffin_pair
    got = dict(tree_flatten_with_paths(to_numpy(port_pair[3])))
    want = dict(tree_flatten_with_paths(jax_pair[3]))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=F32_ATOL,
                                   err_msg=path)


def _requests(make, vocab, specs, *, uid0=0, seed0=70):
    return [make(uid=uid0 + i, prompt=lm_batch(vocab, 1, p, seed=seed0 + i)[0],
                 max_new_tokens=g) for i, (p, g) in enumerate(specs)]


def _swap_run(engine_cls, manager_cls, request_cls, pair, specs, *,
              upgrade_at=2, pool="dense", k=2, capacity=3,
              speculate_after="auto", seed0=70):
    """Serve ``specs`` through a swap at dispatch ``upgrade_at`` with the
    growth done up front.  Returns (engine, manager, outputs)."""
    cfg_src, params_src, cfg_tgt, grown = pair
    eng = engine_cls(cfg_src, params_src, capacity=capacity,
                     max_len=MAX_LEN, k=k, pool=pool)
    mgr = manager_cls(eng, cfg_tgt, grown_params=grown,
                      upgrade_at=upgrade_at, prewarm=False,
                      speculate_after=speculate_after)
    mgr.start(background=False)
    assert mgr.state == "ready"
    got = eng.run(_requests(request_cls, cfg_src.vocab_size, specs,
                            seed0=seed0))
    return eng, mgr, got


def _resumes(mgr):
    return [(r.uid, [int(t) for t in r.prompt], r.n_committed)
            for r in mgr.resumed_requests]


def _assert_split(pair, mgr, got, reqs):
    """Every request was mid-flight at the swap; its committed prefix is
    the source's greedy run and its suffix the grown model's greedy run on
    prompt ‖ committed."""
    cfg_src, params_src, cfg_tgt, grown = pair
    by_uid = {r.uid: r for r in mgr.resumed_requests}
    assert set(by_uid) == {r.uid for r in reqs}
    for r in reqs:
        res = by_uid[r.uid]
        nc = res.n_committed
        assert 0 < nc < r.max_new_tokens
        np.testing.assert_array_equal(res.prompt[:len(res.prompt) - nc],
                                      r.prompt)
        out = np.asarray(got[r.uid])
        assert out.shape == (r.max_new_tokens,)
        pre = generate(cfg_src, params_src, torch.from_numpy(r.prompt)[None],
                       max_new_tokens=nc, max_len=MAX_LEN)[0].numpy()
        np.testing.assert_array_equal(out[:nc], pre, err_msg=f"uid {r.uid}")
        post = generate(cfg_tgt, grown,
                        torch.from_numpy(np.asarray(res.prompt))[None],
                        max_new_tokens=r.max_new_tokens - nc,
                        max_len=MAX_LEN)[0].numpy()
        np.testing.assert_array_equal(out[nc:], post, err_msg=f"uid {r.uid}")


def _against_jax(jax_pair, port_pair, specs, seed0=70, **kw):
    jeng, jmgr, want = _swap_run(JaxEngine, JaxUpgradeManager, JaxRequest,
                                 jax_pair, specs, seed0=seed0, **kw)
    eng, mgr, got = _swap_run(ContinuousBatchingEngine, UpgradeManager,
                              Request, port_pair, specs, seed0=seed0, **kw)
    assert mgr.state == jmgr.state == "swapped"
    assert _resumes(mgr) == _resumes(jmgr)
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid {uid}")
    assert eng.lifetime_totals() == jeng.lifetime_totals()
    assert (mgr.pages_resident_at_swap, mgr.pages_reprefilled) == (
        jmgr.pages_resident_at_swap, jmgr.pages_reprefilled)
    assert eng.n_upgrades == 1 and eng.rejected == {}
    assert eng.cfg.name == port_pair[2].name
    assert mgr.pause_ms is not None and mgr.pause_ms >= 0
    assert all(o == "finished" for o in eng.outcomes.values())
    return eng, mgr, got


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_hot_swap_matches_jax(pool, gpt_pair):
    """gpt-micro -> gpt-micro-big at dispatch 2 with draft-after-swap on
    (JAX's default): JAX's resumes, tokens and counters, and the split."""
    jax_pair, port_pair = gpt_pair
    specs = [(5, 12), (8, 12), (11, 12)]
    eng, mgr, got = _against_jax(jax_pair, port_pair, specs, pool=pool)
    assert eng.pool_kind == pool and eng.speculative is not None
    if pool == "paged":
        assert mgr.pages_resident_at_swap > 0 and eng.pages_in_use == 0
    _assert_split(port_pair, mgr, got,
                  _requests(Request, port_pair[0].vocab_size, specs))


def test_hot_swap_griffin_matches_jax(griffin_pair):
    """griffin's recurrent state and local-attention rings are rebuilt
    through the resume path, not migrated (the port's grown weights
    against JAX's own).  Both
    engines turn speculative after the swap, griffin-micro drafting for
    griffin-micro-big: resumes, tokens and every counter (proposals and
    acceptances too) equal JAX's."""
    jax_pair, port_pair = griffin_pair
    specs = [(5, 10), (9, 10), (7, 10)]
    eng, mgr, got = _against_jax(jax_pair, port_pair, specs, seed0=80)
    assert eng.cache_layout == "recurrent+ring"
    assert eng.speculative is not None and not mgr.spec_reason
    assert eng.speculative.cfg.name == port_pair[0].name
    assert eng.lifetime_totals()["n_spec_proposed"] > 0
    _assert_split(port_pair, mgr, got,
                  _requests(Request, port_pair[0].vocab_size, specs,
                            seed0=80))


# the two MoE families' smoke configs and the wider MoE each grows into
MOE_PAIRS = {
    "phi3.5-moe-42b-smoke": dict(name="phi-smoke-big", n_layers=4,
                                 d_model=128, n_heads=8, n_kv_heads=2,
                                 d_ff=256, expert_d_ff=256),
    "deepseek-v3-671b-smoke": dict(name="ds-smoke-big", n_layers=4,
                                   d_model=128, n_heads=8, n_kv_heads=8,
                                   d_ff=256)}


@pytest.mark.parametrize("src", sorted(MOE_PAIRS))
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_hot_swap_moe_matches_jax(src, pool):
    """An MoE smoke grown into its wider MoE (phi's K/V cache groups,
    deepseek's latent ones) swapped in at dispatch 2 at the published
    capacity factor 1.25, the source drafting afterwards: resumes, tokens
    and counters equal JAX's engine doing the same swap (routing depends
    on the batch shape, so the port is held to JAX's same route, not to
    ``generate``)."""
    jsrc = jax_get_config(src)
    jax_pair, port_pair = _pair(jsrc, jsrc.replace(**MOE_PAIRS[src]))
    specs = [(5, 10), (9, 10), (7, 10)]
    eng, mgr, _ = _against_jax(jax_pair, port_pair, specs, pool=pool,
                               seed0=90)
    assert eng.speculative is not None and not mgr.spec_reason
    assert eng.lifetime_totals()["n_spec_proposed"] > 0
    assert set(eng.pool) == ({"dense", "moe"} if jsrc.mla else {"moe"})
    if pool == "paged":
        assert eng.pages_in_use == 0


def test_draft_after_swap_speculation(gpt_pair):
    """After the swap the old source drafts: speculation really runs and
    the tokens stay the grown model's; proposals and acceptances equal
    JAX's."""
    jax_pair, port_pair = gpt_pair
    specs = [(6, 14), (9, 14)]
    eng, mgr, got = _against_jax(jax_pair, port_pair, specs, capacity=2,
                                 speculate_after=True, seed0=75)
    assert eng.speculative.cfg.name == port_pair[0].name
    assert eng.lifetime_totals()["n_spec_proposed"] > 0
    _assert_split(port_pair, mgr, got,
                  _requests(Request, port_pair[0].vocab_size, specs,
                            seed0=75))


def test_swap_without_draft_and_cold_prewarm_path(gpt_pair):
    """``speculate_after=False`` swaps to the plain grown engine, with the
    same tokens as the speculative swap."""
    _, port_pair = gpt_pair
    specs = [(5, 12), (8, 12), (11, 12)]
    eng, mgr, got = _swap_run(ContinuousBatchingEngine, UpgradeManager,
                              Request, port_pair, specs,
                              speculate_after=False)
    assert eng.speculative is None and mgr.spec_config() is None
    _assert_split(port_pair, mgr, got,
                  _requests(Request, port_pair[0].vocab_size, specs))


def test_submit_during_swap_is_held_not_dropped(gpt_pair):
    """A submit that lands inside the swap is held, then admitted right
    after it: served wholly by the grown model, never refused."""
    _, pair = gpt_pair
    cfg_src, params_src, cfg_tgt, grown = pair
    eng = ContinuousBatchingEngine(cfg_src, params_src, capacity=3,
                                   max_len=MAX_LEN, k=2)
    mgr = UpgradeManager(eng, cfg_tgt, grown_params=grown, upgrade_at=2,
                         prewarm=False, speculate_after=False)
    mgr.start(background=False)
    late = _requests(Request, cfg_src.vocab_size, [(6, 8)], uid0=100,
                     seed0=95)[0]
    configure = eng._configure

    def inject_then_configure(cfg, params, speculative):
        assert eng.upgrade_state == "relayout"
        eng.submit(late)
        assert late.uid not in eng.rejected and not eng.waiting.count(late)
        with pytest.raises(ValueError, match="already submitted"):
            eng.submit(late)
        return configure(cfg, params, speculative)

    eng._configure = inject_then_configure
    reqs = _requests(Request, cfg_src.vocab_size, [(5, 10), (8, 10)],
                     seed0=85)
    got = eng.run(reqs)
    eng._configure = configure
    assert mgr.state == "swapped" and eng.rejected == {}
    assert eng.lifetime_totals()["n_held_for_upgrade"] == 1
    assert eng.outcomes[late.uid] == "finished"
    want = generate(cfg_tgt, grown, torch.from_numpy(late.prompt)[None],
                    max_new_tokens=late.max_new_tokens,
                    max_len=MAX_LEN)[0].numpy()
    np.testing.assert_array_equal(got[late.uid], want)
    _assert_split(pair, mgr, got, reqs)


def test_prewarm_covers_jax_shapes(gpt_pair, monkeypatch):
    """The prewarm admits one group for every (power-of-two group size,
    prefill bucket) JAX's prewarm admits (recorded through a stand-in
    for JAX's scratch engine, so JAX compiles nothing), and the swap
    after it is token-exact."""
    import repro.serve.upgrade as jax_upgrade

    jax_pair, pair = gpt_pair
    shapes = []

    class Scratch:
        def __init__(self, *args, **kw):
            self.prefill_bucket, self.max_len = kw["prefill_bucket"], \
                kw["max_len"]

        def _bucketed(self, n):
            b = self.prefill_bucket
            return min(-(-n // b) * b, self.max_len)

        def run(self, reqs):
            shapes.append((len(reqs), self._bucketed(len(reqs[0].prompt))))

    jeng = JaxEngine(jax_pair[0], jax_pair[1], capacity=3, max_len=20,
                     prefill_bucket=4, k=2)
    jmgr = JaxUpgradeManager(jeng, jax_pair[2], grown_params=jax_pair[3],
                             speculate_after=False)
    monkeypatch.setattr(jax_upgrade, "ContinuousBatchingEngine", Scratch)
    jmgr._prewarm()
    eng = ContinuousBatchingEngine(pair[0], pair[1], capacity=3, max_len=20,
                                   prefill_bucket=4, k=2)
    mgr = UpgradeManager(eng, pair[2], grown_params=pair[3], upgrade_at=2,
                         speculate_after=False)
    mgr.start(background=False)
    assert mgr.prewarm_shapes == shapes
    assert {n for n, _ in shapes} == {1, 2, 3}
    assert {b for _, b in shapes} == {4, 8, 12, 16, 20}
    assert mgr.prewarm_seconds > 0
    reqs = _requests(Request, pair[0].vocab_size, [(5, 8), (7, 8)],
                     seed0=88)
    got = eng.run(reqs)
    assert mgr.state == "swapped"
    _assert_split(pair, mgr, got, reqs)


def _eager_errors(engine_cls, manager_cls, pair, get_config):
    """The message of every eager refusal, in order."""
    cfg_src, params_src, cfg_tgt, grown = pair
    eng = engine_cls(cfg_src, params_src, capacity=2, max_len=MAX_LEN)
    msgs = []
    for tgt, kw in ((get_config("griffin-micro"), {}),
                    (cfg_tgt.replace(vocab_size=996), {}),
                    (cfg_tgt.replace(learned_pos=8, max_seq_len=MAX_LEN),
                     {}),
                    (cfg_tgt, dict(speculate_after="yes"))):
        with pytest.raises((UpgradeError, JaxUpgradeError)) as e:
            manager_cls(eng, tgt, **kw)
        msgs.append(str(e.value))
    mgr = manager_cls(eng, cfg_tgt, grown_params=grown, prewarm=False)
    with pytest.raises((UpgradeError, JaxUpgradeError)) as e:
        manager_cls(eng, cfg_tgt, grown_params=grown, prewarm=False)
    msgs.append(str(e.value))
    assert mgr.state == "serving"  # eager checks never start growth
    return msgs


def test_upgrade_errors_are_named_eager_and_jax_worded(gpt_pair):
    from repro.configs.base import get_config as jget
    from repro_torch.configs import get_config as tget

    jax_pair, pair = gpt_pair
    got = _eager_errors(ContinuousBatchingEngine, UpgradeManager, pair, tget)
    want = _eager_errors(JaxEngine, JaxUpgradeManager, jax_pair, jget)
    assert got == want
    for word, msg in zip(("family", "vocabulary", "position range",
                          "speculate_after", "in flight"), got):
        assert word in msg


def test_failed_growth_keeps_engine_serving(gpt_pair):
    """A growth that raises moves the manager to 'failed' (re-raised on
    ``wait``) and the engine keeps serving the source."""
    _, (cfg_src, params_src, cfg_tgt, _) = gpt_pair
    eng = ContinuousBatchingEngine(cfg_src, params_src, capacity=2,
                                   max_len=MAX_LEN)
    mgr = UpgradeManager(eng, cfg_tgt, prewarm=False, speculate_after=False,
                         method="no-such-method")
    mgr.start(background=True)
    with pytest.raises(ValueError, match="unknown growth method"):
        mgr.wait()
    assert mgr.state == "failed" and mgr.error is not None
    with pytest.raises(UpgradeError, match="start"):
        mgr.start()
    reqs = _requests(Request, cfg_src.vocab_size, [(5, 6), (7, 6)],
                     seed0=92)
    got = eng.run(reqs)
    assert eng.cfg.name == cfg_src.name and eng.n_upgrades == 0
    for r in reqs:
        want = generate(cfg_src, params_src, torch.from_numpy(r.prompt)[None],
                        max_new_tokens=r.max_new_tokens,
                        max_len=MAX_LEN)[0].numpy()
        np.testing.assert_array_equal(got[r.uid], want)
    # a failed upgrade does not block the next one
    UpgradeManager(eng, cfg_tgt, prewarm=False)


def test_manager_growth_matches_jax_growth(gpt_pair):
    """The manager's own growth (Mango rank 1, noise 0, from the engine's
    weights, on a background thread) gives JAX's grown weights within
    2e-5, and the function-preservation probe agrees with JAX's."""
    jax_pair, pair = gpt_pair
    jeng = JaxEngine(jax_pair[0], jax_pair[1], capacity=2, max_len=MAX_LEN)
    jmgr = JaxUpgradeManager(jeng, jax_pair[2], prewarm=False, probe_fp=True,
                             speculate_after=False).start(background=False)
    eng = ContinuousBatchingEngine(pair[0], pair[1], capacity=2,
                                   max_len=MAX_LEN)
    mgr = UpgradeManager(eng, pair[2], prewarm=False, probe_fp=True,
                         speculate_after=False).start(background=True)
    mgr.wait()
    assert mgr.state == "ready" and mgr.grow_seconds > 0
    got = dict(tree_flatten_with_paths(to_numpy(mgr.grown_params)))
    want = dict(tree_flatten_with_paths(
        jax.tree.map(np.asarray, jmgr.grown_params)))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=F32_ATOL,
                                   err_msg=path)
    assert mgr.fp_token_agreement == jmgr.fp_token_agreement


@pytest.mark.parametrize("argv", [
    ["--grow-cfg", "gpt-micro-big"],
    ["--engine", "continuous", "--upgrade-at", "2"],
    ["--engine", "continuous", "--upgrade-sync"],
    ["--engine", "continuous", "--grow-cfg", "griffin-micro"],
    ["--engine", "continuous", "--grow-cfg", "qwen3-0.6b-smoke"],
])
def test_launcher_upgrade_refusals_match_the_reference_text(monkeypatch,
                                                            argv):
    from repro.launch import serve as jax_serve

    argv = ["--arch", "gpt-micro", "--batch", "1", "--gen", "2", *argv]
    with pytest.raises(SystemExit) as port:
        launch_serve.main([*argv, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    with pytest.raises(SystemExit) as reference:
        jax_serve.main()
    assert str(port.value) == str(reference.value)
    assert str(port.value).startswith("error: --")


@pytest.mark.parametrize("sync", [True, False])
def test_launcher_swaps_a_griffin_pair_grown_by_the_port(monkeypatch,
                                                         capsys, sync):
    """The griffin upgrade command on both launchers: griffin-micro (JAX's
    seed-0 weights, converted for the port) grown into griffin-micro-big by
    each package's own upgrade manager and swapped at dispatch 1, synchronously
    or in the background: the swap, the greedy agreement and the
    post-swap draft are JAX's, and synchronously the served tokens too."""
    from repro.launch import serve as jax_serve

    argv = ["--arch", "griffin-micro", "--engine", "continuous", "--batch",
            "2", "--gen", "4", "--grow-cfg", "griffin-micro-big",
            "--upgrade-at", "1"] + (["--upgrade-sync"] if sync else [])
    jparams = jax.tree.map(np.asarray, jax_serve.build_params(
        jax_get_config("griffin-micro")))
    monkeypatch.setattr(launch_serve, "build_params",
                        lambda cfg, **kw: (from_jax(jparams), None, None))
    launch_serve.main([*argv, "--device", "cpu"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    jax_serve.main()
    reference = capsys.readouterr().out

    def facts(out):
        swap = [ln for ln in out.splitlines() if "upgrade SWAPPED" in ln]
        assert len(swap) == 1, out
        tail = swap[0].split("greedy agreement")[1]
        tokens = [ln for ln in out.splitlines() if ln[:1].isdigit()]
        served = [ln.split(" in ")[0].split("served")[1]
                  for ln in out.splitlines() if "served" in ln]
        return tail, tokens, served

    got, want = facts(port), facts(reference)
    # in the background the growth may outlive the trace in one package and
    # not the other: then the swap lands after it, and the tokens are the
    # source's; synchronously it lands at dispatch 1 in both
    assert got[0] == want[0]
    if sync:
        assert got == want
    assert "greedy agreement 1.000; post-swap speculation " \
        "draft=griffin-micro d=4" in port
