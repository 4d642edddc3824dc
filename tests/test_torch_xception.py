"""The port's Xception-analog classifier (``models/xception.py``) and the
twins of ``benchmarks/fig3_training.py`` and ``examples/train_small.py``
against the JAX package on the CPU.

The JAX init is bridged into the port (``params_from_jax``), with the
leaves JAX inits to zeros and ones (the biases, ``bn_scale``) drawn from a
seeded normal in both trees, or they would be untested. Logits, loss,
accuracy and every gradient leaf at f32 2e-5 at image sizes 31, 32 and 33
(XLA's ``"SAME"`` padding of the stride-2 entry conv is (0, 1) at an even
size and (1, 1) at an odd one), 64 and the paper's 299. The fig3 twin's
Xception row equals the JAX module's string for string from the same
initial tree; its LM profiles' loss histories stay within 1e-4 relative of
the JAX ``Trainer``'s, with equal ``steps_to_4.5``. The ``train_small``
twin's resumed run equals an uninterrupted one bit for bit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import xception as j_xc  # noqa: E402
from repro.train.data import DataConfig as JDataConfig  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.benchmarks import fig3_training  # noqa: E402
from repro_torch.launch import train_small  # noqa: E402
from repro_torch.models import xception as t_xc  # noqa: E402
from repro_torch.models.bridge import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models.common import init_scale  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

TOL = 2e-5                     # f32, tests/test_kernels.py:17
TRAINER_RTOL = 1e-4            # tests/test_torch_train_models.py: the port's Trainer against JAX's
# (image size, width, blocks): both pad cases of the stride-2 entry conv, and the paper's resolution
SIZES = [(31, 8, 2), (32, 8, 2), (33, 8, 2), (64, 8, 2), (299, 4, 1)]
B = 3


def _cfgs(size, width, n_blocks):
    return (j_xc.XceptionConfig(img_size=size, width=width, n_blocks=n_blocks),
            t_xc.XceptionConfig(img_size=size, width=width, n_blocks=n_blocks))


def _weights(jcfg, tcfg, seed=0):
    """The JAX init as numpy, its zero and one leaves drawn standard normal,
    in both packages' forms."""
    tree = {k: np.asarray(v) for k, v in j_xc.init(jax.random.PRNGKey(seed), jcfg).items()}
    rng = np.random.default_rng(9)
    drawn = 0
    for k, v in tree.items():
        if not v.any() or (v == 1).all():
            tree[k] = rng.standard_normal(v.shape).astype(np.float32)
            drawn += 1
    assert drawn == 2 + 2 * jcfg.n_blocks
    return {k: jnp.asarray(v) for k, v in tree.items()}, params_from_jax(tree, tcfg, "cpu")


def _task(size, seed=0):
    return fig3_training.task_batch(np.random.default_rng(seed), B, size)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("cfg,n_params", [(dict(), 6532), (dict(width=728, n_blocks=8, img_size=299), 4_327_236),
                                          (dict(width=5, n_blocks=3), 404)], ids=["default", "wide", "narrow"])
def test_param_defs_and_init_match_jax(cfg, n_params):
    """Keys, order and shapes of ``param_defs`` equal JAX's; ``param_shapes``
    are meta tensors of those shapes; the init gives zeros, ones and normal
    draws at JAX's per-leaf scale (1/sqrt of the HWIO kernel's second-last
    axis: 1/sqrt(3) for the entry conv, 1 for each depthwise kernel)."""
    jcfg, tcfg = j_xc.XceptionConfig(**cfg), t_xc.XceptionConfig(**cfg)
    jdefs, tdefs = j_xc.param_defs(jcfg), t_xc.param_defs(tcfg)
    assert list(tdefs) == list(jdefs)
    shapes = t_xc.param_shapes(tcfg)
    for k, jd in jdefs.items():
        td = tdefs[k]
        assert td.shape == jd.shape and td.init == jd.init, k
        assert init_scale(td) == (jd.scale or 1.0 / math.sqrt(max(1, jd.fan_in()))), k
        assert shapes[k].device.type == "meta" and tuple(shapes[k].shape) == jd.shape
    assert init_scale(tdefs["entry"]) == 1 / math.sqrt(3) and init_scale(tdefs["b0_dw"]) == 1.0
    params = t_xc.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    n = 0
    for k, d in tdefs.items():
        t = params[k]
        assert t.dtype == torch.float32 and tuple(t.shape) == d.shape
        n += t.numel()
        if d.init == "zeros":
            assert not t.any(), k
        elif d.init == "ones":
            assert (t == 1).all(), k
        elif t.numel() >= 2000:
            assert abs(float(t.std()) / init_scale(d) - 1) < 0.1, k
    assert n == n_params


@pytest.mark.parametrize("size,width,n_blocks", SIZES)
def test_forward_and_loss_match_jax(size, width, n_blocks):
    jcfg, tcfg = _cfgs(size, width, n_blocks)
    jparams, tparams = _weights(jcfg, tcfg)
    img, lab = _task(size)
    jlogits = j_xc.forward(jcfg, jparams, jnp.asarray(img))
    tlogits = t_xc.forward(tcfg, tparams, img)
    assert tlogits.shape == (B, 4)
    _close(tlogits.numpy(), jlogits)
    (jl, jm) = j_xc.loss_fn(jcfg, jparams, jnp.asarray(img), jnp.asarray(lab))
    (tl, tm) = t_xc.loss_fn(tcfg, tparams, img, lab)
    _close(float(tl), float(jl))
    assert set(tm) == set(jm) and float(tm["acc"]) == float(jm["acc"])


@pytest.mark.parametrize("size,width,n_blocks", SIZES)
def test_every_gradient_leaf_matches_jax(size, width, n_blocks):
    jcfg, tcfg = _cfgs(size, width, n_blocks)
    jparams, tparams = _weights(jcfg, tcfg)
    img, lab = _task(size, seed=1)
    (jl, jm), jg = jax.value_and_grad(lambda p: j_xc.loss_fn(jcfg, p, jnp.asarray(img), jnp.asarray(lab)),
                                      has_aux=True)(jparams)
    (tl, tm), tg = t_xc.value_and_grad(tcfg, tparams, img, lab)
    _close(float(tl), float(jl))
    assert set(tg) == set(jg)
    for k in jg:
        _close(tg[k].numpy(), jg[k])
    assert all(v.grad is None and not v.requires_grad for v in tparams.values())


def test_bridge_checks_xception_shapes():
    jcfg, tcfg = _cfgs(32, 8, 2)
    tree = {k: np.asarray(v) for k, v in j_xc.init(jax.random.PRNGKey(0), jcfg).items()}
    back = params_to_numpy(params_from_jax(tree, tcfg, "cpu"))
    assert all(np.array_equal(back[k], tree[k]) for k in tree)
    with pytest.raises(ValueError):
        params_from_jax(tree, t_xc.XceptionConfig(img_size=32, width=16, n_blocks=2), "cpu")
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in tree.items() if k != "head_b"}, tcfg, "cpu")


def test_fig3_xception_row_matches_jax(monkeypatch, capsys):
    """The twin's ``fig3.xception_analog`` row from the JAX module's own
    initial tree (``init(PRNGKey(0))``, bridged) equals the JAX module's
    row string for string: 60 SGD steps with every step's accuracy equal."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from benchmarks import common as j_common
    from benchmarks import fig3_training as j_fig3

    j_fig3.xception_train()
    j_row = j_common.ROWS[-1]
    jcfg = j_xc.XceptionConfig(img_size=32, width=16, n_blocks=2)
    tree = {k: np.asarray(v) for k, v in j_xc.init(jax.random.PRNGKey(0), jcfg).items()}
    accs = fig3_training.xception_train(device="cpu", params=params_from_jax(
        tree, t_xc.XceptionConfig(img_size=32, width=16, n_blocks=2), "cpu"))
    out = capsys.readouterr().out.strip().splitlines()
    assert j_row.startswith("fig3.xception_analog,0.000,")
    assert out[-1] == j_row and len(accs) == fig3_training.XC_STEPS
    assert np.mean(accs[-10:]) > np.mean(accs[:10]) + 0.2


@pytest.mark.parametrize("batch", [2, 8])
def test_lm_profile_matches_jax_trainer(batch, capsys):
    """``lm_profile`` (40 AdamW steps of smollm SMOKE) from the JAX init:
    every step's loss within 1e-4 relative of the JAX ``Trainer``'s on the
    reference's own configuration, ``steps_to_4.5`` equal."""
    jcfg = j_get_config("smollm-360m", smoke=True).replace(attn_chunk=16, ce_chunks=2)
    jt = JTrainer(j_get_model(jcfg), None,
                  JTrainConfig(steps=40, ckpt_every=10**9, ckpt_dir=None, log_every=1, opt=JOptConfig(lr=2e-3)),
                  JDataConfig(batch_size=batch, seq_len=32, vocab_size=jcfg.vocab_size, seed=5))
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), fig3_training.get_config(
        "smollm-360m", smoke=True), "cpu")
    jr = jt.run(params=jparams)
    tr = fig3_training.lm_profile(f"b{batch}", batch, 40, device="cpu", params=tparams)
    jl, tl = [h["loss"] for h in jr["history"]], [h["loss"] for h in tr["history"]]
    assert len(tl) == len(jl) == 40
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert abs(a - b) <= TRAINER_RTOL * abs(b), (i, a, b)
    hit = lambda ls: next((i for i, x in enumerate(ls) if x < fig3_training.LM_TARGET), -1)  # noqa: E731
    assert hit(tl) == hit(jl) > 0
    row = capsys.readouterr().out.strip().splitlines()[-1]
    assert row.startswith(f"fig3.lm.b{batch},") and row.endswith(f"steps_to_4.5={hit(jl)}")


@pytest.mark.parametrize("steps", [20, 40])
def test_train_small_resumes_bit_for_bit(steps, tmp_path, capsys):
    """``train_small --steps N --device cpu``: the run resumed after the
    crash at N // 2 equals an uninterrupted N-step run bit for bit (logged
    losses and the final parameters), and the loss falls. At N = 20 the
    crash comes before the first checkpoint (every 20 steps), so the
    restart begins at step 0; at N = 40 it resumes from step 20."""
    r = train_small.main(["--steps", str(steps), "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "OK — checkpoint/restart training complete" in out
    assert r["resumed_from"] == (None if steps == 20 else 20)
    assert not (tmp_path / "ck").exists()
    cfg = fig3_training.get_config("smollm-360m", smoke=True).replace(attn_chunk=16, ce_chunks=2)
    full = train_small.make_trainer(cfg, steps, steps, None, "cpu").run(seed=0)
    start = r["resumed_from"] or 0
    tail = [h for h in full["history"] if h["step"] >= start]
    assert r["resumed"]["history"] == tail
    for a, b in zip(leaves(r["resumed"]["params"]), leaves(full["params"])):
        assert torch.equal(a, b)
    assert r["resumed"]["steps_done"] == steps
    assert full["history"][-1]["loss"] < full["history"][0]["loss"] - 0.5
