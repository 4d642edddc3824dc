"""The port's GSPMD half (DTensor parameters through the model API) on 8
gloo ranks on the CPU against the JAX package's 8-device sharded step.

One module-wide run: JAX's test config (glm4-9b SMOKE in f32 at d 64, 4
heads over 2, d_ff 128, attention chunks of 8, two CE chunks, as
``tests/test_multidevice.py::test_small_mesh_train_step_executes`` builds
it) is drawn by JAX's init and bridged to the port, with a batch of 4 x 16
tokens from a numpy seed. A JAX subprocess with 8 forced host devices takes
the sharded gradient and four train steps on a (2, 4) mesh, while a world
of 8 spawned torch ranks over a ``FileStore`` (``torch_gspmd_ranks.py``)
runs the port's. Held: the first step's loss and every gradient leaf
against JAX's and against the port's own ``ctx=None`` step at f32 2e-5
(scaled to the leaf's largest value), the loss curves likewise; every
leaf's placements against the trees; the remesh restore ((4, 2) to (2, 4))
bit for bit; the CE's logits blocks (B/2, C, V/4); the sharded argmax
against ``ctx=None``'s, on a tie across vocab shards too; each kernel
wrapper refusing a DTensor. In this process: the serving methods raising on
a multi-device ctx, a one-device ctx taking the single-device step, and
kernelcheck's DTensor rule.
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import get_model, loss as loss_mod  # noqa: E402
from repro_torch.sharding import axes  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.tree import leaves, paths  # noqa: E402
from torch_gspmd_ranks import INT8_STEPS, LR, STEPS, TP, WORLD, config, params_from  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-5
SPAWN_TIMEOUT_S = 240
B, S = 4, 16
TIE = (140, 300)        # two vocab ids on different model shards (128 ids a shard)

JAX_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.models import get_model
from repro.sharding.axes import make_ctx
from repro.launch.steps import make_train_step, param_shardings, opt_shardings
from repro.train.optimizer import OptConfig, init_opt_state

inp = dict(np.load(sys.argv[1]))
cfg = get_config("glm4-9b", smoke=True).replace(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, attn_chunk=8,
                                                ce_chunks=2)
model = get_model(cfg)
kw = {"axis_types": (jax.sharding.AxisType.Auto,) * 2} if hasattr(jax.sharding, "AxisType") else {}
ctx = make_ctx(jax.make_mesh((2, 4), ("data", "model"), **kw))
key = lambda path: "/" + "/".join(k.key for k in path)
params = jax.tree_util.tree_map_with_path(lambda p, s: jnp.asarray(inp["p" + key(p)]), model.param_shapes())
ocfg = OptConfig(lr=%(lr)r)
params = jax.tree.map(jax.device_put, params, param_shardings(model, ctx, fsdp=True))
opt = init_opt_state(params, ocfg)
opt = jax.tree.map(lambda x, s: jax.device_put(x, s) if s is not None else x, opt, opt_shardings(model, ctx, ocfg))
batch = {"tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(inp["labels"])}
(loss, _), grads = jax.jit(jax.value_and_grad(lambda p: model.loss(ctx, p, batch), has_aux=True))(params)
out = {"loss": np.asarray(loss)}
out.update({"g" + key(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]})
step = jax.jit(make_train_step(model, ctx, ocfg), donate_argnums=(0, 1))
losses = []
for _ in range(%(steps)d):
    params, opt, m = step(params, opt, batch)
    losses.append(float(m["loss"]))
out["losses"] = np.asarray(losses)
np.savez(sys.argv[2], **out)
""" % {"lr": LR, "steps": STEPS}


def _jax_params():
    """JAX's init of the test config (PRNGKey(0)), flat by path."""
    cfg = j_registry.get_config("glm4-9b", smoke=True).replace(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                                                                attn_chunk=8, ce_chunks=2)
    p = j_get_model(cfg).init(jax.random.PRNGKey(0))
    return {"/" + "/".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(p)[0]}


def _inputs(path: Path) -> dict:
    rng = np.random.default_rng(0)
    flat = _jax_params()
    V, d = flat["/unembed"].shape[1], flat["/unembed"].shape[0]
    arrs = {f"p{k}": v for k, v in flat.items()}
    arrs["tokens"] = rng.integers(0, V, (B, S)).astype(np.int32)
    arrs["labels"] = rng.integers(0, V, (B, S)).astype(np.int32)
    arrs["argmax/hidden"] = rng.standard_normal((B, 3, d)).astype(np.float32)
    # two unembedding columns on different model shards, equal and far the largest logit
    u = np.full(d, 0.5, np.float32)
    tie = {k: v.copy() for k, v in flat.items()}
    for j in TIE:
        tie["/unembed"][:, j] = 3 * u
    arrs.update({f"tie/p{k}": v for k, v in tie.items()})
    arrs["tie/hidden"] = np.broadcast_to(u, (B, 3, d)).copy()
    np.savez(path, **arrs)
    return arrs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import multiprocessing

    import torch_gspmd_ranks

    tmp = tmp_path_factory.mktemp("gspmd")
    inputs = _inputs(tmp / "inputs.npz")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "inputs.npz"), str(tmp / "jax.npz")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_gspmd_ranks.run,
                         args=(r, WORLD, str(tmp / "store"), str(tmp / "inputs.npz"), str(tmp)))
             for r in range(WORLD)]
    for pr in procs:
        pr.start()
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for pr in procs:
            pr.join(max(1.0, deadline - time.monotonic()))
        stuck = [r for r, pr in enumerate(procs) if pr.is_alive()]
        _, jerr = jax_run.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    infos = [json.loads((tmp / f"rank{r}.json").read_text()) if (tmp / f"rank{r}.json").exists() else {}
             for r in range(WORLD)]
    errors = [i.get("error") for i in infos if i.get("error")]
    assert not stuck and all(pr.exitcode == 0 for pr in procs), (stuck, [pr.exitcode for pr in procs], errors)
    assert jax_run.returncode == 0, jerr[-3000:]
    model = get_model(config())
    params = params_from(inputs)
    batch = {"tokens": torch.from_numpy(inputs["tokens"]), "labels": torch.from_numpy(inputs["labels"])}
    (loss, _), grads = steps.value_and_grad(model, params, batch)
    ocfg = OptConfig(lr=LR)
    step, p, o, losses = steps.make_train_step(model, ocfg), params, init_opt_state(params, ocfg), []
    for _ in range(STEPS):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    return {"inputs": inputs, "jax": dict(np.load(tmp / "jax.npz")), "infos": infos, "ckpt": tmp / "ckpt",
            "ranks": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)], "model": model,
            "params": params, "single": {"loss": float(loss), "losses": losses,
                                         "grads": dict(zip(paths(grads), leaves(grads)))}}


def _ctx():
    return axes.make_ctx(axes.AbstractMesh((WORLD // TP, TP), ("data", "model")))


def _psh(runs):
    return dict(zip(paths(runs["params"]), leaves(steps.param_shardings(runs["model"], _ctx(), fsdp=True))))


LEAVES = paths(get_model(config()).param_defs())


def test_first_loss_equals_jax_and_ctx_none(runs):
    for info in runs["infos"]:
        assert abs(info["loss"] - float(runs["jax"]["loss"])) < TOL
        assert abs(info["loss"] - runs["single"]["loss"]) < TOL


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_blocks_equal_jax(runs, leaf):
    """Each rank's gradient block against the block of JAX's sharded
    gradient at its mesh position, scaled to the leaf's largest value."""
    full = torch.from_numpy(runs["jax"][f"g{leaf}"])
    sh = _psh(runs)[leaf]
    scale = max(float(full.abs().max()), 1e-30)
    for info, got in zip(runs["infos"], runs["ranks"]):
        want = sh.block(full, info["coord"]).numpy()
        assert got[f"grad{leaf}"].shape == want.shape
        assert np.max(np.abs(got[f"grad{leaf}"] - want)) / scale < TOL, (leaf, info["coord"])


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_blocks_equal_ctx_none(runs, leaf):
    """The same blocks against the port's single-device gradient."""
    full = runs["single"]["grads"][leaf]
    sh = _psh(runs)[leaf]
    scale = max(float(full.abs().max()), 1e-30)
    for info, got in zip(runs["infos"], runs["ranks"]):
        want = sh.block(full, info["coord"]).numpy()
        assert np.max(np.abs(got[f"grad{leaf}"] - want)) / scale < TOL, (leaf, info["coord"])


def test_loss_curve_equals_jax_and_falls(runs):
    jl = runs["jax"]["losses"]
    for info in runs["infos"]:
        got = np.asarray(info["losses"])
        assert np.max(np.abs(got - jl)) < TOL, (got, jl)
        assert np.max(np.abs(got - np.asarray(runs["single"]["losses"]))) < TOL
        assert np.isfinite(got).all() and got[-1] < got[0]
    assert jl[-1] < jl[0]


def test_leaves_in_their_trees_placements(runs):
    """Parameters, states and the step count in the placements of
    ``param_shardings(fsdp=True)`` and ``opt_shardings``, each parameter's
    local block the shape ``NamedSharding.block`` cuts; every gradient in
    its parameter's placements, and the parameters still so after four
    steps."""
    model, ctx = runs["model"], _ctx()
    psh = _psh(runs)
    osh = steps.opt_shardings(model, ctx, OptConfig(lr=LR))
    want = {f"param{p}": str(s.placements) for p, s in psh.items()}
    for k in ("m", "v"):
        want.update({f"{k}{p}": str(s.placements) for p, s in zip(paths(osh[k]), leaves(osh[k]))})
    want["step"] = str(osh["step"].placements)
    full = dict(zip(paths(runs["params"]), leaves(runs["params"])))
    for info in runs["infos"]:
        assert info["placements"] == want
        for p, s in psh.items():
            block = s.block(torch.empty(full[p].shape, device="meta"), info["coord"])
            assert info["local_shapes"][f"param{p}"] == list(block.shape), p
            assert info["grad_placements"][p] == want[f"param{p}"]
            assert info["after_placements"][p] == want[f"param{p}"]


def test_remesh_restore_is_bit_for_bit(runs):
    """Saved under a (4, 2) mesh, restored under (2, 4) with ``shardings=``:
    every rank's blocks equal the saved tree's bit for bit, in the new
    placements; ``shardings=None`` restores the whole tree in one process."""
    psh = _psh(runs)
    full = dict(zip(paths(runs["params"]), leaves(runs["params"])))
    for info, got in zip(runs["infos"], runs["ranks"]):
        assert info["restored_mesh"] == [WORLD // TP, TP]
        for p, s in psh.items():
            assert np.array_equal(got[f"restored{p}"], s.block(full[p], info["coord"]).numpy()), p
            assert info["restored_placements"][p] == str(s.placements)
    back = ckpt.restore(str(runs["ckpt"]), 1, runs["params"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(runs["params"])))


def test_ce_logits_stay_vocab_sharded(runs):
    """Every logits block a rank computes is (B / 2, C, V / 4): the batch
    over 'data', the vocab over 'model', never the whole vocab."""
    cfg = config()
    want = [B // (WORLD // TP), S // cfg.ce_chunks, cfg.vocab_size // TP]
    for info in runs["infos"]:
        assert info["logits_blocks"] and all(sh == want for sh in info["logits_blocks"]), info["logits_blocks"]


@pytest.mark.parametrize("name", ["argmax", "tie"])
def test_sharded_argmax_equals_ctx_none(runs, name):
    """``next_tokens`` and ``next_tokens_all`` over the vocab-sharded logits
    equal the ``ctx=None`` argmax; on the tie the lower id wins."""
    cfg, inp = config(), runs["inputs"]
    tree = params_from(inp, "tie/p") if name == "tie" else runs["params"]
    h = torch.from_numpy(inp[f"{name}/hidden"])
    want, want_all = loss_mod.next_tokens(cfg, tree, h), loss_mod.next_tokens_all(cfg, tree, h)
    if name == "tie":
        assert (want == TIE[0]).all() and (want_all == TIE[0]).all()
    spec = axes.NamedSharding(_ctx().mesh, axes.P("data"))
    for info, got in zip(runs["infos"], runs["ranks"]):
        assert np.array_equal(got[f"{name}/tokens"], spec.block(want, info["coord"]).numpy())
        assert np.array_equal(got[f"{name}/tokens_all"], spec.block(want_all, info["coord"]).numpy())


def test_kernel_wrappers_refuse_dtensors(runs):
    for info in runs["infos"]:
        assert info["refused"] and all(v.startswith("TypeError") and "DTensor" in v
                                       for v in info["refused"].values()), info["refused"]


def test_sharded_moe_through_local_map_equals_the_explicit_body(runs):
    """``moe_ffn_sharded`` (DTensor leaves and x, the body under
    ``local_map``) gives each rank the explicit sharded ``moe_ffn``'s block
    and aux bit for bit, laid out as x; a gradient through it raises."""
    for got in runs["ranks"]:
        assert np.array_equal(got["moe/out"], got["moe/want"]) and np.array_equal(got["moe/aux"], got["moe/want_aux"])
        assert str(got["moe/placements"]) == "(Shard(dim=0), Replicate())"
        assert int(got["moe/raised"]) == 1


def test_trainer_on_the_mesh_resumes_as_one_process_trains(runs):
    """``Trainer(ctx=)``: 2 sharded steps checkpointed every step (each
    rank's leaves gathered, rank 0 writing), then a fresh trainer resuming
    onto the mesh to step 3; every step's loss equals a one-process
    ``ctx=None`` trainer's straight run at f32 2e-5."""
    from torch_gspmd_ranks import trainer_losses

    want = trainer_losses(runs["model"], None)["straight"]
    for info in runs["infos"]:
        got = info["trainer"]
        assert sorted(got["first"]) == ["0", "1"] and sorted(got["resumed"]) == ["2"]
        for step, loss in {**got["first"], **got["resumed"]}.items():
            assert abs(loss - want[int(step)]) < TOL, (step, loss, want)


def test_int8_states_step_as_on_one_process(runs):
    """Two sharded steps with int8 AdamW states against a one-process int8
    run: q in the parameter's placements and the scales without the last
    dim's sharding (a block that spans ranks is quantized from the gathered
    values); losses at f32 2e-5; every state block's q within 1 of the
    one-process q's block (a rounding tie of gradients 1e-7 apart) and equal
    on all but 1 % of it, its scales within f32 2e-5 (relative); every
    parameter within 2e-5 but where such a flip moved its second update
    (there by less than lr)."""
    model, ctx = runs["model"], _ctx()
    ocfg = OptConfig(lr=LR, state_dtype="int8")
    osh = steps.opt_shardings(model, ctx, ocfg)
    want_pl = {f"{k}{p}": str(s.placements) for k in ("m", "v") for p, s in zip(paths(osh[k]), leaves(osh[k]))}
    step, p, o, losses = steps.make_train_step(model, ocfg), runs["params"], init_opt_state(runs["params"], ocfg), []
    inp = runs["inputs"]
    batch = {"tokens": torch.from_numpy(inp["tokens"]), "labels": torch.from_numpy(inp["labels"])}
    for _ in range(INT8_STEPS):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
    full = dict(zip(paths(p), leaves(p)))
    states = {f"{k}{q}": (t, s) for k in ("m", "v") for q, t, s in zip(paths(o[k]), leaves(o[k]), leaves(osh[k]))}
    psh = _psh(runs)
    for info, got in zip(runs["infos"], runs["ranks"]):
        assert info["int8_placements"] == want_pl
        assert np.max(np.abs(np.asarray(info["int8_losses"]) - losses)) < TOL
        for key, (t, s) in states.items():
            want = s.block(t, info["coord"]).numpy()
            if key.endswith("/q"):
                d = np.abs(got[f"int8/{key}"].astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 0.01, key
            else:
                assert np.max(np.abs(got[f"int8/{key}"] - want) / np.maximum(np.abs(want), 1e-30)) < TOL, key
        for leaf, sh in psh.items():
            d = np.abs(got[f"int8/param{leaf}"] - sh.block(full[leaf], info["coord"]).numpy())
            assert d.max() < LR and (d > TOL).mean() < 0.01, leaf


def test_staged_group_runs_dtensors_collectives(runs):
    """A ``sharding.staged`` group (the backend of ranks sharing a card)
    gives DTensor's functional collectives gloo's results: each rank's
    ``arange(2 * world) + rank`` all-gathered, reduce-scattered,
    all-reduced and exchanged all-to-all."""
    x = np.stack([np.arange(2.0 * WORLD) + r for r in range(WORLD)])
    for r, got in enumerate(runs["ranks"]):
        assert str(got["staged/backend"]) == "StagedGloo"
        assert np.array_equal(got["staged/all_gather"], x.reshape(-1))
        assert np.array_equal(got["staged/all_reduce"], x.sum(0))
        assert np.array_equal(got["staged/reduce_scatter"], x.sum(0)[2 * r:2 * r + 2])
        assert np.array_equal(got["staged/all_to_all"], x[:, 2 * r:2 * r + 2].reshape(-1))


SERVING = {
    "prefill": lambda m, p, ctx: m.prefill(p, {"tokens": torch.zeros(4, 8, dtype=torch.long)}, ctx=ctx),
    "prefill_paged": lambda m, p, ctx: m.prefill_paged(p, {"tokens": torch.zeros(1, 8), "tab_row": [1],
                                                           "slot": 0}, None, ctx=ctx),
    "prefill_chunk": lambda m, p, ctx: m.prefill_chunk(p, {"tokens": torch.zeros(1, 8), "offset": 0}, None, None,
                                                       ctx=ctx),
    "prefill_chunk_paged": lambda m, p, ctx: m.prefill_chunk_paged(
        p, {"tokens": torch.zeros(1, 8), "offset": 0, "tab_row": [1], "slot": 0}, None, None, ctx=ctx),
    "verify": lambda m, p, ctx: m.verify(p, {"tokens": torch.zeros(1, 3), "offset": 0}, None, ctx=ctx),
    "verify_paged": lambda m, p, ctx: m.verify_paged(p, {"tokens": torch.zeros(1, 3), "offset": 0,
                                                         "tab_row": [1]}, None, ctx=ctx),
    "decode": lambda m, p, ctx: m.decode(p, None, {"token": torch.zeros(4, 1), "cache_index": 3}, ctx=ctx),
}


@pytest.mark.parametrize("method", sorted(SERVING))
def test_serving_on_a_multi_device_mesh_raises(method):
    """The paged, chunked and verify methods, and prefill and decode, raise
    on a ctx over more than one device (their sequence-sharded cache waits
    for ROADMAP Queue 1 item 10, sub-item 5); the sequence-sharded
    activations raise too."""
    from repro_torch.models.transformer import _constrain

    model = get_model(config())
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="sub-item 5"):
        SERVING[method](model, params, _ctx())
    with pytest.raises(NotImplementedError, match="sub-item 2"):
        _constrain(_ctx(), torch.zeros(4, 8, 64), seq_shard=True)


def test_one_device_ctx_takes_the_single_device_step():
    """A ctx over one device steps as ctx=None, bit for bit, and the trees
    on its mesh give the one device every leaf whole."""
    ctx = axes.make_ctx(axes.AbstractMesh((1, 1), ("data", "model")))
    model = get_model(config())
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 512, (2, 16), generator=g),
             "labels": torch.randint(0, 512, (2, 16), generator=g)}
    ocfg = OptConfig(lr=LR)
    a = steps.make_train_step(model, ocfg)(params, init_opt_state(params, ocfg), batch)
    b = steps.make_train_step(model, ocfg, ctx=ctx)(params, init_opt_state(params, ocfg), batch)
    for i in (0, 1):
        assert all(torch.equal(x, y) for x, y in zip(leaves(a[i]), leaves(b[i])))
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    for t, s in zip(leaves(params), leaves(steps.param_shardings(model, ctx, fsdp=True))):
        assert s.block(t, {"data": 0, "model": 0}).shape == t.shape


def test_kernelcheck_flags_a_wrapper_without_the_dtensor_refusal(tmp_path):
    """``kernelcheck.check_dtensor``: the port's wrappers are clean, and a
    copy of the kernels whose rmsnorm wrapper lost its refusal is flagged
    there and nowhere else."""
    from repro_torch.analysis import kernelcheck

    kernels = REPO / "src" / "repro_torch" / "kernels"
    assert kernelcheck.check_dtensor(str(kernels)) == []
    root = tmp_path / "kernels"
    shutil.copytree(kernels, root, ignore=shutil.ignore_patterns("build", "__pycache__"))
    ops = root / "rmsnorm" / "ops.py"
    ops.write_text(ops.read_text().replace('    _build.refuse_dtensor("rmsnorm", x, w)\n', ""))
    found = kernelcheck.check_dtensor(str(root))
    assert [(f.code, f.path.endswith("rmsnorm/ops.py")) for f in found] == [("dtensor-unrefused", True)]
