"""The port's training pieces against the JAX package on the CPU: the loss,
the optimizer, the schedules, the data, checkpoints, the kernels' autograd
Functions, and the launcher.

Held at f32 2e-5 (``tests/test_kernels.py:17``) unless a test says
otherwise: ``lm_loss`` value and gradients (1 and 2 chunks, softcap,
IGNORE rows, z-loss); ``quantize_blockwise`` bit for bit at .5 ties and on
leaves with no block; one ``adamw_update`` a state dtype, with the clip
active and not; the schedules' values; ``SyntheticLM`` and ``FileTokens``
batches bit for bit; checkpoints round-tripping, atomic, refusing a shape,
and crossing between the packages both ways (bf16 bit for bit). Each
kernel's ``torch.autograd.Function`` runs here with its launch replaced by
the plain version, and must give the plain version's gradients. The model
losses, train steps and the trainer are in ``test_torch_train_models.py``.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs.registry import list_archs as j_list_archs  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.loss import lm_loss as j_lm_loss  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import schedule as jsched  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as mk_ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ref as mk_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models.loss import IGNORE, lm_loss  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import schedule as tsched  # noqa: E402
from repro_torch.train.tree import leaves, paths  # noqa: E402

TOL = 2e-5                     # f32, tests/test_kernels.py:17
ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Configs: the two training knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", j_list_archs())
@pytest.mark.parametrize("smoke", [False, True])
def test_remat_and_ce_chunks_match_jax(arch, smoke):
    """Every configuration's ``remat`` and ``ce_chunks``, FULL and SMOKE,
    as the JAX package sets them."""
    mine, theirs = get_config(arch, smoke=smoke), j_get_config(arch, smoke=smoke)
    assert (mine.remat, mine.ce_chunks) == (theirs.remat, theirs.ce_chunks)


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ce_chunks", [1, 2])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_lm_loss_value_and_grad_match_jax(ce_chunks, softcap):
    """The twin of ``test_chunked_ce_matches_naive_value_and_grad``: loss,
    ce, z and tokens, and the gradients for the hidden states and the
    unembedding, against the JAX package's ``lm_loss`` (z-loss on, the first
    3 positions of row 0 and all of row 2's second half IGNORE)."""
    rng = np.random.default_rng(0)
    B, S, d, V = 3, 16, 32, 96
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = IGNORE
    labels[2, S // 2:] = IGNORE
    jcfg = j_get_config("smollm-360m", smoke=True).replace(ce_chunks=ce_chunks, logit_softcap=softcap)
    tcfg = get_config("smollm-360m", smoke=True).replace(ce_chunks=ce_chunks, logit_softcap=softcap)

    def jf(h, w_):
        return j_lm_loss(jcfg, None, {"unembed": w_, "embedding": jnp.zeros((V, d))}, h, jnp.asarray(labels))

    (jl, jm), (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                                                              jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl, tm = lm_loss(tcfg, {"unembed": tw, "embedding": torch.zeros(V, d)}, th, torch.from_numpy(labels))
    tgh, tgw = torch.autograd.grad(tl, (th, tw))
    assert abs(float(tl.detach()) - float(jl)) < TOL
    for k in ("ce", "z", "tokens"):
        assert abs(float(tm[k].detach()) - float(jm[k])) < TOL, k
    assert float(tm["tokens"]) == B * S - 3 - S // 2
    np.testing.assert_allclose(tgh.numpy(), _np(jgh), atol=TOL, rtol=0)
    np.testing.assert_allclose(tgw.numpy(), _np(jgw), atol=TOL, rtol=0)


def test_lm_loss_all_ignored_counts_one():
    """No valid position: the loss is 0 over a count of 1, as JAX's
    ``maximum(cnt, 1)`` gives it."""
    cfg = get_config("smollm-360m", smoke=True)
    loss, m = lm_loss(cfg, {"unembed": torch.ones(4, 8)}, torch.ones(1, 2, 4),
                      torch.full((1, 2), IGNORE))
    assert float(loss) == 0.0 and float(m["tokens"]) == 1.0


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

# last dims: 256 (block 128), 96 (32), 40 (8), 7 and 4 (no block), scalar
Q_SHAPES = [(3, 256), (5, 96), (2, 3, 40), (7,), (3, 4), ()]


@pytest.mark.parametrize("shape", Q_SHAPES, ids=str)
def test_quantize_blockwise_bit_for_bit(shape):
    """q and scale equal the JAX package's bit for bit, on normal values
    and on values placed at .5 ties of a scale of 1 (each block's absmax
    127, the rest k + 0.5: half to even in both); dequantize too."""
    rng = np.random.default_rng(1)
    xs = [np.asarray(rng.standard_normal(shape) * 3, dtype=np.float32)]
    if shape and topt._block_for(shape[-1]):
        b = topt._block_for(shape[-1])
        ties = (rng.integers(-120, 120, shape) + 0.5).astype(np.float32)
        blocks = ties.reshape(*shape[:-1], shape[-1] // b, b)
        blocks[..., 0] = 127.0
        xs.append(blocks.reshape(shape))
    for x in xs:
        jq = jopt.quantize_blockwise(jnp.asarray(x))
        tq = topt.quantize_blockwise(torch.from_numpy(x))
        np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
        np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
        np.testing.assert_array_equal(topt.dequantize_blockwise(tq, shape).numpy(),
                                      np.asarray(jopt.dequantize_blockwise(jq, shape)))


def _opt_trees(rng):
    """A parameter tree of f32 leaves of every quantization case and one
    bf16 leaf, and two steps' gradients."""
    shapes = {"a": {"w": (4, 256), "b": (96,)}, "c": (3, 40), "d": (5, 7), "e": (2, 3, 4)}
    p = {"a": {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes["a"].items()},
         **{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items() if k != "a"},
         "f": rng.standard_normal((8, 32)).astype(ml_dtypes.bfloat16)}
    grads = [_map_np(lambda x: (rng.standard_normal(x.shape) * 0.5).astype(x.dtype), p) for _ in range(2)]
    return p, grads


def _map_np(fn, tree):
    return {k: _map_np(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _to_t(tree):
    return _map_np(lambda a: torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
                   if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.array(a)), tree)


def _t_np(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip_norm", [0.5, 1e6])
def test_adamw_update_matches_jax(state_dtype, clip_norm):
    """Two ``adamw_update`` steps from the zero state (the second decodes a
    non-zero one) with a Constant and a WarmupCosine lr, the clip binding
    (0.5) or not (1e6): new parameters, m and v, and the stats against the
    JAX package's. f32 leaves at 2e-5; the bf16 parameter and bf16 states
    within one bf16 ulp; int8 q off by at most 1 (a tie the two f32 paths
    round apart) and scales at 2e-5 relative."""
    rng = np.random.default_rng(2)
    p, grads = _opt_trees(rng)
    ocfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm, state_dtype=state_dtype)
    jo, to = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_t(p)
    js, ts = jopt.init_opt_state(jp, jo), topt.init_opt_state(tp, to)
    for step, g in enumerate(grads):
        lr = None if step == 0 else 3e-3
        jp, js, jstats = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp, jo, lr=lr)
        tp, ts, tstats = topt.adamw_update(_to_t(g), ts, tp, to, lr=lr)
        assert abs(float(tstats["grad_norm"]) - float(jstats["grad_norm"])) < TOL
        assert float(tstats["lr"]) == float(jstats["lr"])
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for a, b, path in zip(leaves(tp), jax.tree.leaves(jp), paths(tp)):
            a, b = _t_np(a), _np(b)
            tol = 2 ** -7 * np.abs(b) if path == "/f" else TOL
            assert np.all(np.abs(a - b) <= tol), path
        for a, b in zip(leaves({"m": ts["m"], "v": ts["v"]}), jax.tree.leaves({"m": js["m"], "v": js["v"]})):
            a, b = _t_np(a), np.asarray(b)
            if a.dtype == np.int8:
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            elif state_dtype == "bfloat16":
                assert np.all(np.abs(a - b.astype(np.float32)) <= 2 ** -7 * np.abs(b.astype(np.float32)))
            else:
                np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    assert topt.state_bytes(ts) == sum(np.asarray(x).nbytes for x in jax.tree.leaves(js))


def test_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    p, _ = _opt_trees(rng)
    assert abs(float(topt.global_norm(_to_t(p))) - float(jopt.global_norm(jax.tree.map(jnp.asarray, p)))) < TOL


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", [dict(peak_lr=3e-4, warmup_steps=100, total_steps=10000),
                                   dict(peak_lr=2e-3, warmup_steps=5, total_steps=30, final_frac=0.2),
                                   dict(peak_lr=1e-3, warmup_steps=0, total_steps=1)], ids=str)
def test_warmup_cosine_matches_jax(sched):
    """WarmupCosine at every step through warmup, the cosine and past the
    end, in f32: within one f32 rounding of JAX's values."""
    steps = np.unique(np.concatenate([np.arange(0, 40), np.linspace(0, 12000, 97).astype(int)]))
    j, t = jsched.WarmupCosine(**sched), tsched.WarmupCosine(**sched)
    a = np.array([float(t(int(s))) for s in steps], np.float32)
    b = np.array([float(j(int(s))) for s in steps], np.float32)
    np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)
    assert t(torch.tensor(7, dtype=torch.int32)).dtype == torch.float32


def test_constant_schedule_matches_jax():
    assert float(tsched.Constant(1e-3)(5)) == float(jsched.Constant(1e-3)(5))
    assert tsched.Constant(1e-3)(torch.tensor(2)).dtype == torch.float32


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_synthetic_batches_bit_for_bit(shard):
    cfg = dict(batch_size=3, seq_len=17, vocab_size=128, seed=4, shard_id=shard[0], num_shards=shard[1])
    a, b = tdata.SyntheticLM(tdata.DataConfig(**cfg)), jdata.SyntheticLM(jdata.DataConfig(**cfg))
    for step in (0, 1, 9):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a.batch_at(step)[k], b.batch_at(step)[k])
    assert isinstance(tdata.make_source(tdata.DataConfig(**cfg)), tdata.SyntheticLM)


def test_file_tokens_bit_for_bit(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(5).integers(0, 1000, 5000).astype(np.int32).tofile(path)
    cfg = dict(batch_size=4, seq_len=33, vocab_size=1000, seed=2, path=str(path))
    a, b = tdata.make_source(tdata.DataConfig(**cfg)), jdata.make_source(jdata.DataConfig(**cfg))
    assert isinstance(a, tdata.FileTokens)
    for step in (0, 3):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a.batch_at(step)[k], b.batch_at(step)[k])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _tree_t():
    return {"b": {"c": torch.arange(5, dtype=torch.float32).to(torch.bfloat16) * 0.37},
            "a": torch.arange(12.0).reshape(3, 4), "step": torch.tensor(7, dtype=torch.int32),
            "q": torch.arange(-6, 6, dtype=torch.int8).reshape(2, 6)}


def _tree_j():
    t = _tree_t()
    return {"b": {"c": jnp.asarray(t["b"]["c"].float().numpy()).astype(jnp.bfloat16)},
            "a": jnp.asarray(t["a"].numpy()), "step": jnp.asarray(7, jnp.int32),
            "q": jnp.asarray(t["q"].numpy())}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_roundtrip(tmp_path):
    t = _tree_t()
    ckpt.save(str(tmp_path), 7, t, meta={"note": "x"})
    assert ckpt.latest_step(str(tmp_path)) == 7
    back = ckpt.restore(str(tmp_path), 7, t)
    for a, b in zip(leaves(t), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert ckpt.load_meta(str(tmp_path), 7)["note"] == "x"
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert [r["dtype"] for r in manifest["leaves"]] == ["float32", "bfloat16", "int8", "int32"]


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    """A directory without a manifest (a torn write) and a tmp dir are not
    checkpoints."""
    ckpt.save(str(tmp_path), 5, _tree_t())
    (tmp_path / "step_00000009").mkdir()
    (tmp_path / ".tmp_step_00000011").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_restore_rejects_shape_and_count_mismatch(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2, 2)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(3, 3)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(2, 2), "b": torch.zeros(1)})


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """The JAX package's save, read by the port: every leaf bit for bit
    (bf16 included, written by numpy from ml_dtypes), in its order."""
    jckpt.save(str(tmp_path), 3, _tree_j())
    back = ckpt.restore(str(tmp_path), 3, _tree_t())
    for a, b in zip(leaves(_tree_t()), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_into_jax(tmp_path):
    """The port's save, read by the JAX package's restore: bf16 arrives as
    bfloat16, bit for bit, every leaf in JAX's flatten order."""
    ckpt.save(str(tmp_path), 4, _tree_t())
    back = jckpt.restore(str(tmp_path), 4, _tree_j())
    for a, b in zip(jax.tree.leaves(_tree_j()), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_restore_places_leaves_on_a_given_device(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree_t())
    back = ckpt.restore(str(tmp_path), 2, _tree_t(), device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(back))


# ---------------------------------------------------------------------------
# The kernels' autograd Functions, their launches replaced by the plain versions
# ---------------------------------------------------------------------------


def _grads_of(fn, inputs, seed=0):
    """Gradients of sum(out * r) over every output for each input, r a
    seeded normal per output."""
    xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    total = sum((o.float() * torch.randn(o.shape, generator=g)).sum() for o in outs)
    wrt = [x for x in xs if x.requires_grad]
    return [o.detach() for o in outs], torch.autograd.grad(total, wrt)


def _same_grads(fn_a, fn_b, inputs):
    oa, ga = _grads_of(fn_a, inputs)
    ob, gb = _grads_of(fn_b, inputs)
    for a, b in zip(oa + list(ga), ob + list(gb)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=TOL, rtol=0)


def test_rmsnorm_function_gives_the_plain_gradients(monkeypatch):
    monkeypatch.setattr(rms_ops, "_launch", lambda x, w, eps: rmsnorm_ref(x, w, eps))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 5, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    _same_grads(lambda a, b: rms_ops.RMSNormFn.apply(a, b, 1e-6), lambda a, b: rmsnorm_ref(a, b), (x, w))


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_function_gives_the_plain_gradients(monkeypatch, layout):
    monkeypatch.setattr(fa_ops, "_launch", fa_ops._plain)
    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 2, 13, 6, 2, 16
    shp = (lambda h: (B, S, h, hd)) if layout == "bshd" else (lambda h: (B, h, S, hd))
    q, k, v = (torch.from_numpy(rng.standard_normal(shp(h)).astype(np.float32)) for h in (H, KV, KV))
    _same_grads(lambda a, b, c: fa_ops.FlashFn.apply(a, b, c, layout),
                lambda a, b, c: fa_ops._plain(a, b, c, layout), (q, k, v))


def test_mlstm_function_gives_the_plain_gradients(monkeypatch):
    """h and the carry outputs (C, n, m) all carry gradients, from a
    non-zero carry, in three chunks."""
    monkeypatch.setattr(mk_ops, "_launch",
                        lambda *a: mk_ref.mlstm_chunkwise_bh_ref(*a[:8], chunk=a[8]))
    rng = np.random.default_rng(8)
    BH, S, DH = 3, 12, 32
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    inputs = (f(BH, S, DH), f(BH, S, DH), f(BH, S, DH), f(BH, S),
              torch.nn.functional.logsigmoid(f(BH, S) + 2), f(BH, DH, DH) * 0.1, f(BH, DH) * 0.1, f(BH))
    _same_grads(lambda *a: mk_ops.MLSTMFn.apply(*a, 4),
                lambda *a: mk_ref.mlstm_chunkwise_bh_ref(*a, chunk=4), inputs)


def test_functions_take_only_wanted_gradients(monkeypatch):
    """Only the inputs that require grad get one (w alone here)."""
    monkeypatch.setattr(rms_ops, "_launch", lambda x, w, eps: rmsnorm_ref(x, w, eps))
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    w = torch.ones(8, requires_grad=True)
    out = rms_ops.RMSNormFn.apply(x, w, 1e-6)
    (gw,) = torch.autograd.grad(out.sum(), (w,))
    want = torch.autograd.grad(rmsnorm_ref(x, w).sum(), (w,))[0]
    torch.testing.assert_close(gw, want, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# The launcher and the import rule
# ---------------------------------------------------------------------------


def test_launch_train_smoke_on_the_cpu(tmp_path):
    """``launch.train --smoke --device cpu``: 20 steps with a checkpoint
    every 10, the loss falling; a second call resumes at step 20 of 24."""
    from repro_torch.launch import train

    argv = ["--smoke", "--device", "cpu", "--steps", "20", "--ckpt-every", "10", "--ckpt-dir",
            str(tmp_path), "--log-every", "1", "--seq-len", "32"]
    r = train.main(argv)
    h = [m["loss"] for m in r["history"]]
    assert r["steps_done"] == 20 and len(h) == 20 and h[-1] < h[0] - 0.5
    assert ckpt.latest_step(str(tmp_path)) == 20
    r2 = train.main(argv[:4] + ["24"] + argv[5:])
    assert [m["step"] for m in r2["history"]] == [20, 21, 22, 23]


def test_train_imports_no_jax():
    code = ("import sys; import repro_torch.train.trainer, repro_torch.launch.train, "
            "repro_torch.launch.steps; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, env={"PYTHONPATH": str(ROOT / "src"),
                                                                  "PATH": "/usr/bin:/bin"})
