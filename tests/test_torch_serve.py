"""The port's serving path (``ServeEngine``, ``DRScheduler``,
``launch/serve.py``) and the telemetry it records, held against the
reference on the CPU.

The engine runs the reference's smoke gemma-2b with carried parameters:
``steps`` and ``tokens_out`` must be equal, and the greedy tokens equal
wherever the reference's top-two logit margin at that step exceeds 1e-2
(float32 sums run in another order, so a near-tie may break the other
way; after such a step the two continuations may differ).  The scheduler
is host numpy on both sides: every route, imbalance, checkpoint dict,
migration count and decision-log entry must be equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduce_for_smoke
from repro.configs.registry import get_config
from repro.control import Telemetry as JTelemetry
from repro.core.drm import DRConfig as JDRConfig
from repro.exchange import ExchangeStats as JStats
from repro.models import model as jmodel
from repro.models.modules import Policy as JPolicy
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import DRScheduler as JScheduler
from repro_torch.carry import params_from_jax
from repro_torch.compat import overlap_enabled
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.control import Telemetry as TTelemetry
from repro_torch.core.drm import DRConfig
from repro_torch.exchange import ExchangeStats as TStats
from repro_torch.launch import serve as tserve
from repro_torch.models.modules import Policy as TPolicy
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.scheduler import DRScheduler as TScheduler

JPOL = JPolicy(attn_q_chunk=64, attn_kv_chunk=64)
TPOL = TPolicy(attn_q_chunk=64, attn_kv_chunk=64)
MARGIN = 1e-2


def _models(arch="gemma-2b"):
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = tbase.reduce_for_smoke(treg.get_config(arch))
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(0), JPOL)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, TPOL, device="cpu")
    return cfg, tcfg, jparams, tparams


def _margins(cfg, params, prompt, tokens):
    """The reference's top-two margin over the vocabulary at each greedy
    step of ``tokens`` (teacher-forced)."""
    def margin(logits):
        top = np.sort(np.asarray(logits[0, -1, : cfg.vocab_size], np.float64))[-2:]
        return top[1] - top[0]

    logits, cache = jmodel.prefill(params, {"tokens": jnp.asarray(prompt[None], jnp.int32)},
                                   cfg, JPOL, max_len=64)
    out = [margin(logits)]
    for tok in tokens[:-1]:
        logits, cache = jmodel.decode_step(params, cache, jnp.asarray([[tok]], jnp.int32),
                                           cfg, JPOL)
        out.append(margin(logits))
    return out


@pytest.mark.parametrize("arch,slots,n_req,prompt_len,max_new", [
    ("gemma-2b", 2, 5, 8, 4),          # tests/test_train_serve.py's engine scenario
    ("gemma-2b", 3, 7, 19, 6),
    ("gemma3-27b", 2, 4, 21, 5),       # local layers past their 16-slot window
])
def test_engine_matches_reference(arch, slots, n_req, prompt_len, max_new):
    cfg, tcfg, jparams, tparams = _models(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
               for _ in range(n_req)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    jeng = JEngine(cfg, jparams, JPOL, slots=slots, max_len=64)
    teng = TEngine(tcfg, tparams, TPOL, slots=slots, max_len=64, device="cpu")
    jeng.run(jreqs, max_ticks=100)
    teng.run(treqs, max_ticks=100)
    assert (teng.steps, teng.tokens_out) == (jeng.steps, jeng.tokens_out)
    assert all(r.done for r in treqs) and [r.done for r in treqs] == [r.done for r in jreqs]
    for p, jr, tr in zip(prompts, jreqs, treqs):
        assert len(tr.out_tokens) == len(jr.out_tokens) == max_new
        assert all(0 <= t < cfg.vocab_size for t in tr.out_tokens)
        if tr.out_tokens == jr.out_tokens:
            continue
        first = next(i for i, (a, b) in enumerate(zip(tr.out_tokens, jr.out_tokens)) if a != b)
        assert _margins(cfg, jparams, p, jr.out_tokens)[first] <= MARGIN, (jr.rid, first)


def test_engine_targets_the_card_by_default():
    _, tcfg, _, tparams = _models()
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="parameters lie on cpu"):
            TEngine(tcfg, tparams, TPOL)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TEngine(tcfg, tparams, TPOL)
    assert TEngine(tcfg, tparams, TPOL, device="cpu").device.type == "cpu"


def test_engine_stops_at_eos():
    cfg, tcfg, jparams, tparams = _models()
    prompt = np.arange(8, dtype=np.int32)
    jr, tr = JRequest(0, prompt, 6), TRequest(0, prompt, 6)
    JEngine(cfg, jparams, JPOL, slots=1, max_len=64).run([jr])
    eos = jr.out_tokens[2]
    jr2, tr2 = JRequest(0, prompt, 6), TRequest(0, prompt, 6)
    jeng = JEngine(cfg, jparams, JPOL, slots=1, max_len=64, eos_id=eos)
    teng = TEngine(tcfg, tparams, TPOL, slots=1, max_len=64, eos_id=eos, device="cpu")
    jeng.run([jr2])
    teng.run([tr2])
    assert tr2.out_tokens == jr2.out_tokens and (teng.steps, teng.tokens_out) == (
        jeng.steps, jeng.tokens_out)


# ---------------------------------------------------------------------------
# the DR scheduler
# ---------------------------------------------------------------------------


def _hot_tenant_keys():
    rng = np.random.default_rng(3)
    hot = np.array([7, 13, 99, 1234])
    r = rng.random(8000)
    return np.where(r < 0.4, hot[rng.integers(0, 4, 8000)],
                    rng.integers(0, 5000, 8000)).astype(np.int64)


def _drive(sched, keys, dr_enabled):
    """``tests/test_train_serve.py``'s hot-tenant scenario; every
    observable of every window."""
    trace = []
    for i in range(8):
        win = keys[i * 1000: (i + 1) * 1000]
        routes = [sched.route(int(k), cost_tokens=1.0) for k in win]
        trace.append(("routes", routes, sched.imbalance()))
        if dr_enabled:
            trace.append(("checkpoint", sched.checkpoint(win)))
        sched.drain(tokens_per_replica=150)
        trace.append(("queues", [r.queued_tokens for r in sched.replicas],
                      [sorted(r.sessions) for r in sched.replicas]))
    return trace


def _decisions(sched):
    return {k: np.asarray(v).tolist() for k, v in sched.drm.decisions.to_arrays().items()}


@pytest.mark.parametrize("dr_enabled", [True, False])
def test_scheduler_matches_reference_exactly(dr_enabled):
    keys = _hot_tenant_keys()
    jsched, tsched = JScheduler(8), TScheduler(8)
    jt, tt = _drive(jsched, keys, dr_enabled), _drive(tsched, keys, dr_enabled)
    assert tt == jt
    assert (tsched.migrations, tsched.routed) == (jsched.migrations, jsched.routed)
    assert _decisions(tsched) == _decisions(jsched)
    snap_t, snap_j = tsched.drm.snapshot(), jsched.drm.snapshot()
    assert sorted(snap_t) == sorted(snap_j)
    for k in snap_j:
        np.testing.assert_array_equal(np.asarray(snap_t[k]), np.asarray(snap_j[k]), err_msg=k)
    if dr_enabled:
        assert tsched.migrations > 0
        checkpoints = [x[1] for x in tt if x[0] == "checkpoint"]
        assert any(c["repartitioned"] for c in checkpoints)


@pytest.mark.parametrize("disable", ["", "1", "true", "0"])
def test_scheduler_overlap_switch_matches_reference(monkeypatch, disable):
    """``REPRO_DISABLE_OVERLAP`` reaches the checkpoint schema and the
    telemetry the session moves record, as in the reference."""
    monkeypatch.setenv("REPRO_DISABLE_OVERLAP", disable)
    keys = _hot_tenant_keys()
    jsched, tsched = JScheduler(4, seed=5), TScheduler(4, seed=5)
    assert tsched.overlap_active() == jsched.overlap_active() == overlap_enabled()
    assert overlap_enabled() == (disable in ("", "0"))
    for i in range(4):
        win = keys[i * 2000: (i + 1) * 2000]
        for k in win:
            assert tsched.route(int(k), 2.0) == jsched.route(int(k), 2.0)
        assert tsched.checkpoint(win) == jsched.checkpoint(win)
        st, sj = tsched.telemetry.snapshot(np.ones(4)), jsched.telemetry.snapshot(np.ones(4))
        assert (st.exchange_rows, st.exchange_count_wall_s, st.backend_wall_ewma) == (
            sj.exchange_rows, sj.exchange_count_wall_s, sj.backend_wall_ewma)


def test_scheduler_resize_is_not_ported():
    """``resize`` is ported (``tests/test_torch_elastic.py`` holds it to the
    reference); what the scheduler still cannot run raises, citing its
    ROADMAP item, and a resize to no replica is refused as in the
    reference."""
    with pytest.raises(ValueError):
        TScheduler(4).resize(0)
    with pytest.raises(ValueError):
        JScheduler(4).resize(0)
    assert TScheduler(4).resize(4) == JScheduler(4).resize(4) == 0
    # the BackendPolicy is ported: the scheduler constructs with it
    # (tests/test_torch_backends.py holds its checkpoints to the reference)
    assert TScheduler(4, dr=DRConfig(auto_backend=True)).drm.config.auto_backend
    # lane health is ported: the scheduler constructs with it, and its
    # checkpoints (one replica-set "lane" view, no fault evidence) are the
    # reference's
    keys = _hot_tenant_keys()
    tsched = TScheduler(4, dr=DRConfig(health_enabled=True))
    jsched = JScheduler(4, dr=JDRConfig(health_enabled=True))
    for i in range(3):
        win = keys[i * 2000: (i + 1) * 2000]
        for k in win:
            assert tsched.route(int(k), 2.0) == jsched.route(int(k), 2.0)
        assert tsched.checkpoint(win) == jsched.checkpoint(win)
    assert tsched.drm.lane_health.num_lanes == jsched.drm.lane_health.num_lanes == 1


def test_telemetry_queue_depths_and_exchange_walls_match():
    jt, tt = JTelemetry("serve"), TTelemetry("serve")
    for tel, stats in ((jt, JStats), (tt, TStats)):
        tel.record_batch(10.0)
        tel.record_queues(np.array([3.0, 1.0, 4.0]))
        tel.record_exchange(stats(rows=5, wall_s=0.25, backend="dense", count_wall_s=0.1))
        tel.record_exchange(stats(rows=2, wall_s=0.5, backend="dense", count_wall_s=None))
        tel.record_exchange(stats(rows=1, backend="ragged", count_wall_s=0.0))
    sj, st = jt.snapshot(np.ones(3)), tt.snapshot(np.ones(3))
    np.testing.assert_array_equal(st.queue_depths, sj.queue_depths)
    assert (st.exchange_rows, st.exchange_wall_s, st.exchange_count_wall_s,
            st.backend_wall_ewma) == (sj.exchange_rows, sj.exchange_wall_s,
                                      sj.exchange_count_wall_s, sj.backend_wall_ewma)
    again = tt.snapshot(np.ones(3))  # the window resets; the EWMA does not
    assert again.queue_depths is None and again.exchange_count_wall_s == 0.0
    assert again.backend_wall_ewma == st.backend_wall_ewma


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_serve_prints_the_reference_lines(capsys, monkeypatch):
    """The port's launcher on the CPU prints the reference launcher's lines
    (the wall-clock total aside)."""
    from repro.launch import serve as jserve

    args = ["--requests", "12", "--max-new", "6", "--slots", "3", "--replicas", "3"]
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    tserve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    assert got[:3] == want[:3] and got[4] == want[4]
    assert got[3].split(" total ")[0] == want[3].split(" total ")[0]
    assert got[0] == "replica 0: 5 requests, 25 tokens, 10 ticks"


def test_launch_serve_targets_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--requests", "2", "--max-new", "2"])
