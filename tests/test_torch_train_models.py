"""Training through the port's models against the JAX package on the CPU.

``model.loss`` and its gradient for every parameter leaf against
``jax.value_and_grad(model.loss)`` at SMOKE size, on the JAX init bridged
into the port (``params_from_jax``; the leaves JAX inits to zeros, such as
q/k/v and layernorm biases, Mamba's ``conv_b``/``dt_bias``/``A_log`` and the
mLSTM gate bias, drawn standard normal into both trees, or they would be
untested): smollm, glm4-9b, dbrx-132b (the MoE aux term), jamba, xlstm-350m,
qwen2-vl-2b's ``EmbedsLM`` (M-RoPE positions of an image prompt) and
whisper's ``EncDecLM``, at f32 2e-5 of each leaf's largest gradient (or of
1). ``remat`` none, full and dots give identical bits on the CPU. The train
step with microbatches 1 and 2 against JAX's; a 10-step ``Trainer``
trajectory against JAX's ``Trainer`` on the bridged init; a resume that
repeats the trajectory bit for bit, the preemption save-and-exit, falling
loss.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.vlm import mrope_positions_with_image  # noqa: E402
from repro.train.data import DataConfig as JDataConfig  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import init_opt_state as j_init_opt_state  # noqa: E402
from repro.train.schedule import WarmupCosine as JWarmupCosine  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step, value_and_grad  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models.loss import IGNORE  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import DataConfig  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.schedule import WarmupCosine  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
from repro_torch.train.tree import leaves, paths  # noqa: E402

TOL = 2e-5                     # f32, tests/test_kernels.py:17
ARCHS = ("smollm-360m", "glm4-9b", "dbrx-132b", "jamba-1.5-large-398b", "xlstm-350m", "qwen2-vl-2b",
         "whisper-large-v3")
B, S = 2, 16


def _normal_zeros(tree, rng):
    """Every leaf of a numpy tree that JAX inits to zeros, drawn standard
    normal (in place); returns how many."""
    n = 0
    for key, node in tree.items():
        if isinstance(node, dict):
            n += _normal_zeros(node, rng)
        elif not node.any():
            tree[key] = rng.standard_normal(node.shape).astype(np.float32)
            n += 1
    return n


def _weights(arch, **over):
    jcfg = j_get_config(arch, smoke=True).replace(**over)
    tcfg = get_config(arch, smoke=True).replace(**over)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    drawn = _normal_zeros(tree, np.random.default_rng(9))
    assert drawn > 0 or arch in ("smollm-360m", "dbrx-132b")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, "cpu")


def _batch(cfg, seed=0):
    """A numpy batch for ``cfg``'s model: tokens (or embeddings and an
    image prompt's M-RoPE positions, or frames) and labels with IGNORE
    rows."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :4] = IGNORE
    batch = {"labels": labels}
    if cfg.inputs == "embeds":
        batch["inputs_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        pos = np.asarray(mrope_positions_with_image(B, S, 2, 2, 3))
        batch["positions"] = np.array(np.broadcast_to(pos, (3, B, S)))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal((B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _j_value_and_grad(jcfg, jparams, batch):
    model = j_get_model(jcfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(None, p, b), has_aux=True))
    return fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})


def _assert_grads(tgrads, jgrads, tol=TOL):
    """Every leaf, in JAX's flatten order, within ``tol`` of the leaf's
    largest value (or of 1)."""
    t_np = params_to_numpy(tgrads)
    for path, a, b in zip(paths(t_np), leaves(t_np), jax.tree.leaves(jgrads)):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, path
        scale = max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max()) if a.size else 0.0
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _weights(arch)
    batch = _batch(tcfg)
    (jl, jm), jg = _j_value_and_grad(jcfg, jparams, batch)
    (tl, tm), tg = value_and_grad(get_model(tcfg), tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) < TOL, (float(tl), float(jl))
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) < TOL, k
    if tcfg.moe is not None:
        assert float(tm["moe_aux"]) > 0
    _assert_grads(tg, jg)


@pytest.mark.parametrize("arch", ["smollm-360m", "dbrx-132b", "xlstm-350m", "whisper-large-v3"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_identical_loss_and_gradients(arch, remat):
    """Recomputing every superblock (``full``) or all but its weight
    products (``dots``) changes no bit of the loss or of any gradient."""
    tcfg = get_config(arch, smoke=True)
    params = get_model(tcfg).init(torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, seed=2).items()}
    (l0, _), g0 = value_and_grad(get_model(tcfg.replace(remat="none")), params, batch)
    (l1, _), g1 = value_and_grad(get_model(tcfg.replace(remat=remat)), params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


def test_remat_checkpoints_each_superblock(monkeypatch):
    """Under ``full`` each superblock's forward runs twice (the recompute in
    the backward), under ``none`` once; without a gradient nothing is
    wrapped."""
    from repro_torch.models import transformer as ttf

    calls = []
    orig = ttf._superblock
    monkeypatch.setattr(ttf, "_superblock", lambda *a, **k: calls.append(1) or orig(*a, **k))
    tcfg = get_config("smollm-360m", smoke=True)
    params = get_model(tcfg).init(torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    for remat, want in (("none", 2), ("full", 4)):
        calls.clear()
        value_and_grad(get_model(tcfg.replace(remat=remat)), params, batch)
        assert len(calls) == want, remat
    calls.clear()
    get_model(tcfg.replace(remat="full")).loss(params, batch)
    assert len(calls) == 2


def test_remat_rejects_an_unknown_policy():
    tcfg = get_config("smollm-360m", smoke=True).replace(remat="some")
    params = get_model(tcfg).init(torch.Generator().manual_seed(1))
    with pytest.raises(ValueError):
        value_and_grad(get_model(tcfg), params, {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()})


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """Two train steps (f32 states, WarmupCosine at step 0 and 1) of
    smollm SMOKE: metrics, every updated parameter and state leaf against
    the JAX package's steps at f32 2e-5. With 2 microbatches the gradients
    accumulate in bf16 in both, where an f32 gradient a rounding apart may
    round to neighbouring bf16 values: m and v are held at bf16 2e-2, and
    the parameters at lr * 2**-7, what one bf16 ulp of a gradient can move
    an AdamW update."""
    jcfg, tcfg, jparams, tparams = _weights("smollm-360m")
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    jo, to = JOptConfig(lr=1e-2), OptConfig(lr=1e-2)
    jstep = jax.jit(j_make_train_step(j_get_model(jcfg), None, jo, schedule=JWarmupCosine(**sched),
                                      microbatches=microbatches))
    tstep = make_train_step(get_model(tcfg), to, schedule=WarmupCosine(**sched), microbatches=microbatches)
    js, ts = j_init_opt_state(jparams, jo), init_opt_state(tparams, to)
    for i in range(2):
        batch = _batch(tcfg, seed=10 + i)
        jparams, js, jm = jstep(jparams, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, ts, tm = tstep(tparams, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(tm) == set(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) < TOL * max(1.0, abs(float(jm[k]))), (i, k)
        _assert_grads(tparams, jparams, TOL if microbatches == 1 else 1e-2 * 2 ** -7)
        state_tol = TOL if microbatches == 1 else 2e-2
        _assert_grads(ts["m"], js["m"], state_tol)
        _assert_grads(ts["v"], js["v"], state_tol)


def _trainers(tmp_path, steps, jparams=None, ckpt_dir=None):
    tcfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=16, ce_chunks=2)
    tc = TrainConfig(steps=steps, ckpt_every=5, ckpt_dir=ckpt_dir, log_every=1, opt=OptConfig(lr=1e-3))
    dc = DataConfig(batch_size=2, seq_len=16, vocab_size=tcfg.vocab_size, seed=3)
    return Trainer(get_model(tcfg), tc, dc, device="cpu")


def test_trainer_trajectory_matches_jax(tmp_path):
    """10 steps of the port's Trainer and of JAX's on the same (bridged)
    init and data: every step's loss, ce and grad norm within 1e-4 relative
    (the two f32 paths round apart and ten AdamW steps carry it), the final
    parameters within 1e-4 of each leaf's largest value."""
    jcfg, tcfg, jparams, tparams = _weights("smollm-360m", attn_chunk=16, ce_chunks=2)
    jt = JTrainer(j_get_model(jcfg), None,
                  JTrainConfig(steps=10, ckpt_every=5, log_every=1, opt=JOptConfig(lr=1e-3)),
                  JDataConfig(batch_size=2, seq_len=16, vocab_size=jcfg.vocab_size, seed=3))
    jr = jt.run(params=jparams)
    tr = _trainers(tmp_path, 10).run(params=tparams)
    assert tr["steps_done"] == jr["steps_done"] == 10
    for a, b in zip(tr["history"], jr["history"]):
        assert a["step"] == b["step"]
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (a["step"], k, a[k], b[k])
    t_np = params_to_numpy(tr["params"])
    for path, a, b in zip(paths(t_np), leaves(t_np), jax.tree.leaves(jr["params"])):
        b = np.asarray(b, np.float32)
        assert float(np.abs(a - b).max()) <= 1e-4 * max(1.0, float(np.abs(b).max())), path


def test_restart_resumes_identical_trajectory(tmp_path):
    """10 steps straight == 5 steps, then a fresh Trainer resuming from the
    checkpoint at step 5: the losses of steps 5-9 and the final parameters
    bit for bit."""
    full = _trainers(tmp_path, 10, ckpt_dir=str(tmp_path / "full")).run(seed=0)
    _trainers(tmp_path, 5, ckpt_dir=str(tmp_path / "resume")).run(seed=0)
    resumed = _trainers(tmp_path, 10, ckpt_dir=str(tmp_path / "resume")).run(seed=0)
    assert resumed["steps_done"] == 10
    tail_full = [h["loss"] for h in full["history"] if h["step"] >= 5]
    assert [h["loss"] for h in resumed["history"]] == tail_full
    for a, b in zip(leaves(full["params"]), leaves(resumed["params"])):
        assert torch.equal(a, b)
    assert int(resumed["opt_state"]["step"]) == 10


def test_loss_decreases_on_synthetic_data(tmp_path):
    r = _trainers(tmp_path, 40).run(seed=0)
    losses = [h["loss"] for h in r["history"]]
    assert losses[-1] < losses[0] - 0.3, losses[:3] + losses[-3:]


def test_preemption_saves_and_exits(tmp_path):
    tr = _trainers(tmp_path, 50, ckpt_dir=str(tmp_path))
    orig = tr._step_fn

    def step_then_preempt(*a, **k):
        out = orig(*a, **k)
        tr._preempted = True     # SIGTERM arriving mid-run
        return out

    tr._step_fn = step_then_preempt
    r = tr.run(seed=0)
    assert r["preempted"] and r["steps_done"] == 1
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.load_meta(str(tmp_path), 1) == {"preempted": True}


def test_sigterm_handler_sets_preempted(tmp_path):
    import os
    import signal

    tr = _trainers(tmp_path, 3)
    old = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert tr._preempted
    finally:
        signal.signal(signal.SIGTERM, old)


def test_prefill_and_decode_steps_call_the_model():
    """``make_prefill_step`` and ``make_decode_step`` run the model's
    prefill (into a fresh cache of ``cap``) and decode: the tokens of a
    prefill and two decode steps equal the model's own calls'."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    tcfg = get_config("smollm-360m", smoke=True)
    model = get_model(tcfg)
    params = model.init(torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_batch(tcfg)["tokens"][:, :7]).long()
    tok_s, cache_s = make_prefill_step(model, cap=12)(params, {"tokens": toks})
    tok_m, cache_m = model.prefill(params, {"tokens": toks}, cap=12)
    assert torch.equal(tok_s, tok_m) and cache_s["blocks"]["l0_mixer"]["k"].shape[2] == 12
    decode = make_decode_step(model)
    for i in range(2):
        batch = {"token": tok_s[:, None], "cache_index": 7 + i}
        tok_s, cache_s = decode(params, cache_s, batch)
        tok_m, cache_m = model.decode(params, cache_m, batch)
        assert torch.equal(tok_s, tok_m)
